"""The lean step (mid-step BCs skipped) must be EXACTLY the reference
pipeline from any BC-consistent state — including ghost entries."""
import numpy as np
import jax.numpy as jnp
import pytest

import tpuvof as tv
from tpuvof.ops import apply_bc
from tpuvof.solver import step, step_counted


def bc_state(state):
    u, v, F, p = apply_bc(state.u, state.v, state.F, state.p)
    return tv.State(F=F, u=u, v=v, p=p)


def test_lean_step_exactly_equals_full_step():
    cfg = tv.SimConfig(grid=tv.Grid2D(24, 24))
    state = bc_state(tv.simulate(cfg, tv.init_state(cfg, ic=1), 7))
    for parity in (False, True):
        a = step(cfg, state, even_step=parity, lean=False)
        b = step(cfg, state, even_step=parity, lean=True)
        for name, x, y in zip(("F", "u", "v", "p"), a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=name)


def test_lean_chain_stays_exact():
    """Over a chain of steps: end-of-step BC keeps the state BC-consistent,
    so leanness composes."""
    cfg = tv.SimConfig(grid=tv.Grid2D(20, 20))
    a = bc_state(tv.init_state(cfg, ic=3))
    b = a
    for i in range(1, 8):
        a = step(cfg, a, even_step=(i % 2 == 0), lean=False)
        b = step(cfg, b, even_step=(i % 2 == 0), lean=True)
    for name, x, y in zip(("F", "u", "v", "p"), a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)


@pytest.mark.parametrize("solver", ["jacobi", "rbsor", "mg"])
def test_step_counted_is_step_plus_its_solve_count(solver):
    """step_counted returns step's state exactly, and the iterations its
    pressure solve took: the fixed sweep count (jacobi), or the
    while_loop's trip count within [1, sor_max_iter] (rbsor, mg)."""
    num = tv.Numerics(pressure_solver=solver, sor_max_iter=40,
                      sor_tol_rel=1e-2 if solver == "mg" else 0.0)
    cfg = tv.SimConfig(grid=tv.Grid2D(16, 16), num=num)
    state = bc_state(tv.simulate(cfg, tv.init_state(cfg, ic=1), 3))
    got, iters = step_counted(cfg, state, even_step=True, lean=True)
    want = step(cfg, state, even_step=True, lean=True)
    for name, x, y in zip(("F", "u", "v", "p"), got, want):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=name)
    if solver == "jacobi":
        assert int(iters) == num.n_jacobi
    else:
        assert 1 <= int(iters) <= num.sor_max_iter
