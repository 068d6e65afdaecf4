"""Generate the 1000-step dam-break golden trajectory (VERDICT r1 #2).

Runs the loop-based executable spec (tests/reference_numpy.py — the stand-in
oracle for the Taichi reference, which is not installable here) once at 64^2
f64 for 1000 steps and commits the end state as tests/golden_dambreak_64_1000.npz.
The accuracy criterion (F L-inf <= 1e-5 vs the reference over 1000
dam-break steps) is then pinned by tests/test_golden.py against this
file at every round instead of only 30 steps.

Takes ~10 minutes (pure-Python loops); run once, commit the npz.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
from reference_numpy import RefSolver2D  # noqa: E402

N = 64
N_STEPS = 1000

CHECKPOINT = 300  # early checkpoint: rounding noise still ~1e-15 there, so
# it pins systematic bias ~1000x tighter than the chaotic 1000-step horizon

s = RefSolver2D(N, N, n_jacobi=10, dtype=np.float64)
s.set_init_F(1)
t0 = time.perf_counter()
mid = {}
for t in range(1, N_STEPS + 1):
    s.step(t)
    if t == CHECKPOINT:
        mid = dict(F300=s.F.copy(), u300=s.u.copy(), v300=s.v.copy(),
                   p300=s.p.copy())
    if t % 100 == 0:
        print(f"step {t}/{N_STEPS}  ({time.perf_counter() - t0:.0f}s)", flush=True)

out = os.path.join(os.path.dirname(__file__), "..", "tests",
                   "golden_dambreak_64_1000.npz")
np.savez_compressed(out, F=s.F, u=s.u, v=s.v, p=s.p,
                    n=N, n_steps=N_STEPS, n_jacobi=10, checkpoint=CHECKPOINT,
                    **mid)
print("wrote", out)
print("mass:", s.F[1:-1, 1:-1].sum(), "max|u|:", np.abs(s.u).max())
