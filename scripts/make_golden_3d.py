"""Generate a long-horizon 3-D dam-break golden trajectory.

Runs the loop-based 3-D spec (tests/reference_numpy.py::RefSolver3D) once
at 32^3 f64 for 300 steps and commits the end state (plus a step-100
checkpoint) as tests/golden_dambreak3d_32_300.npz. tests/test_golden.py
pins the framework's 3-D f64 trajectory
against it every round — the 3-D analogue of the 2-D 1000-step north-star
pin, sized so the pure-Python loop spec finishes in minutes.

Run once, commit the npz.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
from reference_numpy import RefSolver3D  # noqa: E402

N = 32
N_STEPS = 300
CHECKPOINT = 100

s = RefSolver3D(N, dtype=np.float64)
s.set_init_F()
t0 = time.perf_counter()
mid = {}
for t in range(1, N_STEPS + 1):
    s.step(t)
    if t == CHECKPOINT:
        mid = dict(F100=s.F.copy(), u100=s.u.copy(), v100=s.v.copy(),
                   w100=s.w.copy())
    if t % 50 == 0:
        print(f"step {t}/{N_STEPS}  ({time.perf_counter() - t0:.0f}s)",
              flush=True)

out = os.path.join(os.path.dirname(__file__), "..", "tests",
                   "golden_dambreak3d_32_300.npz")
np.savez_compressed(out, n=N, n_steps=N_STEPS, checkpoint=CHECKPOINT,
                    F=s.F, u=s.u, v=s.v, w=s.w, p=s.p, **mid)
print("wrote", out, f"({os.path.getsize(out)/1e6:.2f} MB)")
