"""Produce docs/dam_break_3d.gif: the 200^3 dam break, rendered as the
z = L/6 VOF slice (inside the initial fluid column — the mid-depth plane
starts empty) every 1000 steps.

Run on the GPU (40000 steps + frame I/O; needs matplotlib and PIL). The
phase schedule stays continuous across frame chunks via istep0.
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import tpuvof as tv  # noqa: E402
from tpuvof.grid import Grid3D  # noqa: E402
from tpuvof.solver3d import simulate_3d  # noqa: E402
from tpuvof.io_utils import frames_to_gif  # noqa: E402

N = 200
STEPS = 40000
EVERY = 1000
OUT = os.path.join(os.path.dirname(__file__), "..", "docs")

g = Grid3D(N, N, N)
state = tv.init_state_3d(g, ic=1)
frames_dir = tempfile.mkdtemp(prefix="demo3d")
paths = []
done = 0
while done < STEPS:
    state = simulate_3d(g, state, EVERY, istep0=done)
    done += EVERY
    sl = np.asarray(state.F)[1:-1, 1:-1, N // 6].T
    fig, ax = plt.subplots(figsize=(3.2, 3.2), dpi=100)
    ax.imshow(sl, origin="lower", cmap="Blues", vmin=0.0, vmax=1.0)
    ax.set_axis_off()
    ax.set_title(f"200$^3$ dam break, z=L/6 plane, step {done}", fontsize=8)
    fig.tight_layout(pad=0.1)
    p = os.path.join(frames_dir, f"{done:06d}.png")
    fig.savefig(p)
    plt.close(fig)
    paths.append(p)
    print(f"step {done}/{STEPS}", flush=True)

gif = os.path.join(OUT, "dam_break_3d.gif")
frames_to_gif(paths, gif, fps=12)
print("wrote", gif, f"({os.path.getsize(gif)/1e6:.2f} MB)")
