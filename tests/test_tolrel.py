"""Relative stopping tolerance for the residual-driven pressure solvers
(Numerics.sor_tol_rel; ops.poisson.effective_tol).

An ABSOLUTE sor_tol is unreachable for production-scale flows (the rhs is
rho/dt * div(u*) ~ 1e8), so without a relative mode every upgraded step
burns the iteration cap / runs to the f32 floor. sor_tol_rel raises the
effective tolerance to
tol_rel * max|rhs'| per solve. These tests pin:
  - all four solver sites honor it (2-D/3-D rbsor, mg, distributed rbsor);
  - the solve actually STOPS at the relative target (early exit), not at
    the floor;
  - the distributed trip count matches serial (global pmax scale);
  - sor_tol_rel=0.0 (default) leaves the absolute semantics untouched.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import tpuvof as tv
from tpuvof.grid import Grid2D, Grid3D
from tpuvof.ops.mg import mg_solve
from tpuvof.ops.poisson import _rbsor, effective_tol, residual


def _random_rhs(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    rhs = jnp.asarray(scale * rng.standard_normal(shape))
    return rhs - jnp.mean(rhs)


def test_effective_tol_semantics():
    rhs = _random_rhs((8, 8), seed=1, scale=100.0)
    scale = float(jnp.max(jnp.abs(rhs)))
    # rel mode: max(abs, rel * scale)
    assert float(effective_tol(1e-3, 1e-2, rhs)) == pytest.approx(
        max(1e-3, 1e-2 * scale))
    # huge absolute tol wins the max
    assert float(effective_tol(1e6, 1e-2, rhs)) == 1e6
    # rel=0 returns the Python float unchanged (same traced program)
    assert effective_tol(1e-3, 0.0, rhs) == 1e-3
    assert isinstance(effective_tol(1e-3, 0.0, rhs), float)


@pytest.mark.parametrize("solver", ["rbsor", "mg"])
def test_relative_stop_2d(solver):
    """With sor_tol=0 and sor_tol_rel=rel the solve reaches rel*max|rhs'|
    and STOPS there (the residual stays well above the f64 floor a
    run-to-stall solve would reach) — for an rhs whose absolute scale
    (1e8, the production magnitude) makes the absolute default useless."""
    n = 64
    g = Grid2D(n, n)
    rhs = _random_rhs((n, n), seed=7, scale=1e8)
    scale = float(jnp.max(jnp.abs(rhs)))
    rel = 1e-2
    p0 = jnp.zeros((n + 2, n + 2))
    if solver == "mg":
        p = mg_solve(p0, rhs, (g.dxi**2, g.dyi**2), tol=0.0,
                     max_cycles=100, tol_rel=rel)
    else:
        nm = tv.Numerics(pressure_solver="rbsor", sor_tol=0.0,
                         sor_tol_rel=rel, sor_max_iter=5000)
        p = _rbsor(g, nm, p0, rhs)
    r = float(residual(g, p, rhs))
    assert r <= rel * scale
    # early exit, not the floor: a converged-to-stall f64 solve lands many
    # orders lower; one extra iteration/cycle cannot overshoot this far
    assert r > 1e-7 * scale


@pytest.mark.parametrize("solver", ["rbsor", "mg"])
def test_relative_stop_3d(solver):
    n = 16
    g = Grid3D(n, n, n)
    rhs = _random_rhs((n, n, n), seed=5, scale=1e8)
    scale = float(jnp.max(jnp.abs(rhs)))
    rel = 1e-2
    p0 = jnp.zeros((n + 2,) * 3)
    if solver == "mg":
        p = mg_solve(p0, rhs, (g.dxi**2, g.dyi**2, g.dzi**2), tol=0.0,
                     max_cycles=100, tol_rel=rel)
    else:
        from tpuvof.solver3d import _rbsor_3d

        p = _rbsor_3d(g, p0, rhs, omega=1.7, tol=0.0, max_iter=5000,
                      tol_rel=rel)
    from tpuvof.solver3d import _neigh_3d, _poisson_coeffs_3d

    coeffs = _poisson_coeffs_3d(g, p.dtype)
    ap = 1.0 / coeffs[-1]
    I = (slice(1, -1),) * 3
    rr = _neigh_3d(g, coeffs, p, rhs - jnp.mean(rhs)) - ap * p[I]
    rr = rr - jnp.mean(rr)
    r = float(jnp.max(jnp.abs(rr)))
    assert r <= rel * scale
    assert r > 1e-7 * scale


def test_zero_rel_is_bitwise_default():
    """sor_tol_rel=0.0 must not change the solve at all (the tolerance
    stays a compile-time constant; the parity pins keep meaning what they
    pinned)."""
    n = 32
    g = Grid2D(n, n)
    rhs = _random_rhs((n, n), seed=11)
    p0 = jnp.zeros((n + 2, n + 2))
    nm_a = tv.Numerics(pressure_solver="rbsor", sor_tol=1e-6,
                       sor_max_iter=300)
    nm_b = tv.Numerics(pressure_solver="rbsor", sor_tol=1e-6,
                       sor_max_iter=300, sor_tol_rel=0.0)
    pa = _rbsor(g, nm_a, p0, rhs)
    pb = _rbsor(g, nm_b, p0, rhs)
    assert np.array_equal(np.asarray(pa), np.asarray(pb))


def test_step_integration_2d():
    """A full simulate() with the bounded-cost mg upgrade stays finite and
    bounded (the end-to-end route a CLI user takes via --sor-tol-rel)."""
    cfg = tv.SimConfig(grid=tv.Grid2D(32, 32),
                       num=tv.Numerics(pressure_solver="mg", sor_tol=0.0,
                                       sor_tol_rel=1e-2, sor_max_iter=50))
    state = tv.init_state(cfg, ic=1)
    out = tv.simulate(cfg, state, 20)
    F = np.asarray(out.F)
    assert np.isfinite(np.asarray(out.u)).all()
    assert (F >= -1e-12).all() and (F <= 1 + 1e-12).all()


def test_step_integration_3d():
    from tpuvof.solver3d import init_state_3d, simulate_3d

    g = Grid3D(16, 16, 16)
    state = init_state_3d(g, ic=1)
    out = simulate_3d(g, state, 9, pressure_solver="rbsor", sor_tol=0.0,
                      sor_tol_rel=1e-2, sor_max_iter=500)
    F = np.asarray(out.F)
    assert np.isfinite(np.asarray(out.u)).all()
    assert (F >= -1e-12).all() and (F <= 1 + 1e-12).all()


def test_distributed_rbsor_rel_matches_serial():
    """Distributed rbsor under sor_tol_rel: the scale is a GLOBAL pmax,
    so every shard computes the serial effective tolerance — identical
    trip counts, values to collective-reassociation noise (the same
    contract as the absolute-tol parity pin in test_parallel.py)."""
    import jax
    from jax.sharding import Mesh
    from tpuvof.parallel import Decomp

    num = tv.Numerics(pressure_solver="rbsor", sor_tol=0.0,
                      sor_tol_rel=3e-2, sor_max_iter=500)
    cfg = tv.SimConfig(grid=tv.Grid2D(16, 16), num=num)
    state = tv.init_state(cfg, ic=1)
    state = tv.State(*(a.astype(jnp.float64) for a in state))
    want = tv.simulate(cfg, state, 5)
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    got = Decomp(cfg, Mesh(devs, ("mx", "my"))).simulate(state, 5)
    for name in ("F", "u", "v", "p"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name))[1:-1, 1:-1],
            np.asarray(getattr(want, name))[1:-1, 1:-1],
            atol=1e-12, err_msg=name)


def test_distributed_3d_rbsor_rel_matches_serial():
    import jax
    from jax.sharding import Mesh
    from tpuvof.parallel import Decomp3D
    from tpuvof.solver3d import init_state_3d, simulate_3d

    g = Grid3D(16, 16, 16)
    state = init_state_3d(g, ic=1)
    state = type(state)(*(a.astype(jnp.float64) for a in state))
    want = simulate_3d(g, state, 4, pressure_solver="rbsor", sor_tol=0.0,
                       sor_tol_rel=3e-2, sor_max_iter=500)
    mesh = Mesh(np.array(jax.devices()[:2]), ("mx",))
    dec = Decomp3D(g, mesh, pressure_solver="rbsor", sor_tol=0.0,
                   sor_tol_rel=3e-2, sor_max_iter=500)
    got = dec.simulate(state, 4)
    I = (slice(1, -1),) * 3
    for name in ("F", "u", "v", "w", "p"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name))[I],
            np.asarray(getattr(want, name))[I],
            atol=1e-12, err_msg=name)
