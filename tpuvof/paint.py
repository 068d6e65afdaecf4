"""Interactive target painting (reference paint.py and diff_vof.py's
set_init_by_paint, :188-198).

The reference opens a Taichi GUI and stamps 1-blocks under the cursor while
the left button is held. Here the same workflow runs on a matplotlib canvas
when a display (or interactive backend) is available; the stamping logic is
the headless-testable core (`PaintCanvas.stamp`), identical to
diff.paint_blocks' 4x4 semantics (stamp=2) or paint.py's 20x20 (stamp=10).

Headless environments use `diff.paint_blocks` / `--target-npy` instead.
"""
from __future__ import annotations

import numpy as np

from .grid import Grid2D

__all__ = ["PaintCanvas", "paint_interactively"]


class PaintCanvas:
    """Mutable paint buffer with the reference's stamp semantics."""

    def __init__(self, g: Grid2D, stamp: int = 2):
        self.grid = g
        self.stamp = stamp
        self.F = np.zeros(g.shape, np.float32)

    def stamp_at(self, x: float, y: float):
        """Stamp a block of 1s at cursor position (x, y) in [0,1]^2
        (reference set_pixel, diff_vof.py:180-185: int(x*imax) center,
        [-stamp, +stamp) extent, clipped at the low edges)."""
        xc = int(x * self.grid.nx)
        yc = int(y * self.grid.ny)
        s = self.stamp
        i0, i1 = max(0, xc - s), min(self.F.shape[0], xc + s)
        j0, j1 = max(0, yc - s), min(self.F.shape[1], yc + s)
        if i1 > i0 and j1 > j0:
            self.F[i0:i1, j0:j1] = 1.0
        return self.F


def paint_interactively(g: Grid2D, stamp: int = 2, title: str = "Paint your initial"):
    """Open a matplotlib window; LMB-drag paints, closing the window (or
    pressing escape) finishes. Returns the painted (nx+2, ny+2) array.

    Requires an interactive matplotlib backend; raises RuntimeError headless.
    """
    from .io_utils import optional_import

    matplotlib = optional_import("matplotlib", "--paint")
    import matplotlib.pyplot as plt

    noninteractive = {b.lower() for b in matplotlib.rcsetup.non_interactive_bk}
    if matplotlib.get_backend().lower() in noninteractive:
        raise RuntimeError(
            "no interactive display: paint a target programmatically with "
            "diff.paint_blocks or pass --target-npy to the CLI"
        )

    canvas = PaintCanvas(g, stamp=stamp)
    fig, ax = plt.subplots()
    fig.canvas.manager.set_window_title(title)
    im = ax.imshow(canvas.F.T, origin="lower", cmap="Blues", vmin=0, vmax=1,
                   extent=[0, 1, 0, 1])
    ax.set_title("drag LMB to paint; close window when done")
    state = {"down": False}

    def on_press(ev):
        if ev.button == 1 and ev.inaxes is ax:
            state["down"] = True
            im.set_data(canvas.stamp_at(ev.xdata, ev.ydata).T)
            fig.canvas.draw_idle()

    def on_release(ev):
        state["down"] = False

    def on_move(ev):
        if state["down"] and ev.inaxes is ax and ev.xdata is not None:
            im.set_data(canvas.stamp_at(ev.xdata, ev.ydata).T)
            fig.canvas.draw_idle()

    def on_key(ev):
        if ev.key == "escape":
            plt.close(fig)

    fig.canvas.mpl_connect("button_press_event", on_press)
    fig.canvas.mpl_connect("button_release_event", on_release)
    fig.canvas.mpl_connect("motion_notify_event", on_move)
    fig.canvas.mpl_connect("key_press_event", on_key)
    plt.show(block=True)
    return canvas.F
