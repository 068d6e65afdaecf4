"""Produce docs/drop_csf_3d.gif: a 3-D falling liquid drop WITH surface
tension (ic=3 sphere + csf=True — both upgrades over the reference, which
implements neither). Rendered as the z = L/2 mid-plane VOF slice.

Run on the GPU (needs matplotlib and PIL). The phase schedule stays
continuous via istep0.
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

N = int(os.environ.get("N", "200"))
STEPS = int(os.environ.get("STEPS", "40000"))
EVERY = int(os.environ.get("EVERY", "1000"))
OUT = os.path.join(os.path.dirname(__file__), "..", "docs")

g = Grid3D(N, N, N)
state = tv.init_state_3d(g, ic=3)
frames_dir = tempfile.mkdtemp(prefix="democsf3d")
paths = []
done = 0
while done < STEPS:
    state = simulate_3d(g, state, EVERY, istep0=done, csf=True)
    done += EVERY
    sl = np.asarray(state.F)[1:-1, 1:-1, N // 2].T
    fig, ax = plt.subplots(figsize=(3.2, 3.2), dpi=100)
    ax.imshow(sl, origin="lower", cmap="Blues", vmin=0.0, vmax=1.0)
    ax.set_axis_off()
    ax.set_title(f"{N}$^3$ falling drop + CSF, z=L/2, step {done}",
                 fontsize=8)
    fig.tight_layout(pad=0.1)
    p = os.path.join(frames_dir, f"f{done:06d}.png")
    fig.savefig(p)
    plt.close(fig)
    paths.append(p)
    F = np.asarray(state.F)
    print(f"{done}: mass={F[1:-1,1:-1,1:-1].sum():.1f} "
          f"range=[{F.min():.3f},{F.max():.3f}]", flush=True)
    assert np.isfinite(F).all()

gif = os.path.join(OUT, "drop_csf_3d.gif")
frames_to_gif(paths, gif, fps=10)
print("wrote", gif, flush=True)
