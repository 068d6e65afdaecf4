"""Geometric-multigrid pressure solver (ops/mg.py, pressure_solver='mg').

Contract mirrors the rbsor pins (tests/test_parity.py): mg solves the
nullspace-projected system to sor_tol, agrees with rbsor's solution up to
the free constant, integrates into both the 2-D and 3-D steps, and is
explicitly rejected where it has no implementation (distributed drivers,
uncoarsenable grids, unknown-solver typos).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import tpuvof as tv
from tpuvof.grid import Grid2D, Grid3D
from tpuvof.ops.mg import mg_levels, mg_solve
from tpuvof.ops.poisson import residual


def _random_rhs(shape, seed=0):
    rng = np.random.default_rng(seed)
    rhs = jnp.asarray(rng.standard_normal(shape))
    return rhs - jnp.mean(rhs)


def test_levels_ladder():
    assert mg_levels((64, 64)) == [(64, 64), (32, 32), (16, 16), (8, 8), (4, 4)]
    # the reference's 200^2 coarsens three times, then goes odd
    assert mg_levels((200, 200))[-1] == (25, 25)
    # uncoarsenable: a single level
    assert mg_levels((7, 7)) == [(7, 7)]


@pytest.mark.parametrize("n", [64, 200, 48])
def test_solve_to_tol_2d(n):
    g = Grid2D(n, n)
    rhs = _random_rhs((n, n), seed=n)
    tol = 1e-10 * float(g.dxi) ** 2  # relative to the operator scale
    p = mg_solve(jnp.zeros((n + 2, n + 2)), rhs, (g.dxi**2, g.dyi**2),
                 tol=tol, max_cycles=100)
    assert float(residual(g, p, rhs)) <= tol


def test_vcycle_contraction():
    """One V(2,2) cycle contracts the residual >= 10x (measured ~50x;
    guards against a silently broken transfer operator, which would
    degrade MG to smoother speed while still eventually converging)."""
    n = 64
    g = Grid2D(n, n)
    rhs = _random_rhs((n, n), seed=3)
    p0 = jnp.zeros((n + 2, n + 2))
    r0 = float(residual(g, p0, rhs))
    p1 = mg_solve(p0, rhs, (g.dxi**2, g.dyi**2), tol=0.0, max_cycles=1)
    assert float(residual(g, p1, rhs)) < r0 / 10.0


def test_matches_rbsor_solution():
    """mg and rbsor solve the same singular system: tight-tol solutions
    agree up to the free constant."""
    from tpuvof.ops.poisson import _rbsor

    n = 64
    g = Grid2D(n, n)
    nm = tv.Numerics(pressure_solver="rbsor", sor_tol=1e-9 * g.dxi**2,
                     sor_max_iter=20000)
    rhs = _random_rhs((n, n), seed=7)
    p0 = jnp.zeros((n + 2, n + 2))
    p_sor = _rbsor(g, nm, p0, rhs)
    p_mg = mg_solve(p0, rhs, (g.dxi**2, g.dyi**2), tol=nm.sor_tol,
                    max_cycles=200)
    a = np.asarray(p_sor)[1:-1, 1:-1]
    b = np.asarray(p_mg)[1:-1, 1:-1]
    a = a - a.mean()
    b = b - b.mean()
    # residual tol 1e-9*dxi^2 -> error ~ kappa(A)/dxi^2 * tol ~ 1e-6*|p|
    scale = max(np.abs(a).max(), 1.0)
    assert np.max(np.abs(a - b)) < 1e-5 * scale


def test_step_integration_2d():
    """Full solver runs on pressure_solver='mg' and lands within the
    residual-tolerance band of the rbsor trajectory (both solve the same
    projected system to tight tol, so velocities/F must agree closely)."""
    n = 32
    common = dict(sor_tol=1e-8, sor_max_iter=5000)
    cfg_mg = tv.SimConfig(grid=tv.Grid2D(n, n),
                          num=tv.Numerics(pressure_solver="mg", **common))
    cfg_sor = tv.SimConfig(grid=tv.Grid2D(n, n),
                           num=tv.Numerics(pressure_solver="rbsor", **common))
    state0 = tv.init_state(cfg_mg, ic=1)
    state0 = tv.State(*(jnp.asarray(np.asarray(a), jnp.float64)
                        for a in state0))
    s_mg = tv.simulate(cfg_mg, state0, 10)
    s_sor = tv.simulate(cfg_sor, state0, 10)
    F = np.asarray(s_mg.F)
    assert np.isfinite(F).all() and F.min() >= 0 and F.max() <= 1
    for f in ("F", "u", "v"):
        d = float(np.max(np.abs(np.asarray(getattr(s_mg, f))
                                - np.asarray(getattr(s_sor, f)))))
        assert d < 1e-7, (f, d)


def test_step_integration_3d():
    from tpuvof.solver3d import init_state_3d, simulate_3d

    g = Grid3D(16, 16, 16)
    state0 = init_state_3d(g, ic=1)
    state0 = tv.State3D(*(jnp.asarray(np.asarray(a), jnp.float64)
                          for a in state0))
    common = dict(sor_tol=1e-8, sor_max_iter=5000)
    s_mg = simulate_3d(g, state0, 5, pressure_solver="mg", **common)
    s_sor = simulate_3d(g, state0, 5, pressure_solver="rbsor", **common)
    F = np.asarray(s_mg.F)
    assert np.isfinite(F).all() and F.min() >= 0 and F.max() <= 1
    for f in ("F", "u", "v", "w"):
        d = float(np.max(np.abs(np.asarray(getattr(s_mg, f))
                                - np.asarray(getattr(s_sor, f)))))
        assert d < 1e-7, (f, d)


def test_mg_beats_fixed_jacobi_residual():
    """Same property the rbsor pin asserts (test_parity.py): the upgrade
    solver reaches a far smaller residual than 10 fixed Jacobi sweeps."""
    from tpuvof.ops.poisson import solve_pressure

    n = 64
    g = Grid2D(n, n)
    rng = np.random.default_rng(5)
    u_star = jnp.asarray(rng.standard_normal((n + 2, n + 2)))
    v_star = jnp.asarray(rng.standard_normal((n + 2, n + 2)))
    rho = jnp.asarray(1.0 + rng.random((n + 2, n + 2)))
    p0 = jnp.zeros((n + 2, n + 2))
    from tpuvof.ops.poisson import divergence_rhs

    nm_j = tv.Numerics()
    nm_mg = tv.Numerics(pressure_solver="mg", sor_tol=1e-4,
                        sor_max_iter=100)
    rhs = divergence_rhs(g, nm_j, u_star, v_star, rho)
    rhs0 = rhs - jnp.mean(rhs)
    p_j = solve_pressure(g, nm_j, p0, u_star, v_star, rho)
    p_mg = solve_pressure(g, nm_mg, p0, u_star, v_star, rho)
    r_j = float(residual(g, p_j, rhs0, project_nullspace=False))
    r_mg = float(residual(g, p_mg, rhs0, project_nullspace=False))
    assert r_mg < 1e-5 * r_j, (r_j, r_mg)


def test_uncoarsenable_grid_raises():
    g = Grid2D(7, 7)
    with pytest.raises(ValueError, match="rbsor"):
        mg_solve(jnp.zeros((9, 9)), _random_rhs((7, 7)),
                 (g.dxi**2, g.dyi**2), tol=1e-6, max_cycles=10)


def test_unknown_solver_raises():
    cfg = tv.SimConfig(grid=tv.Grid2D(16, 16),
                       num=tv.Numerics(pressure_solver="sor"))
    with pytest.raises(ValueError, match="unknown pressure_solver"):
        tv.simulate(cfg, tv.init_state(cfg, ic=1), 1)


def test_distributed_accepts_mg():
    """Round 4 made mg distributed (parallel/mg.py): Decomp/Decomp3D
    must ACCEPT pressure_solver='mg' (the pre-round-4 rejection is
    gone); deep serial-parity coverage lives in tests/test_mg_dist.py."""
    import jax
    from jax.sharding import Mesh
    from tpuvof.parallel import Decomp, Decomp3D

    cfg = tv.SimConfig(grid=tv.Grid2D(16, 16),
                       num=tv.Numerics(pressure_solver="mg"))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("mx", "my"))
    assert Decomp(cfg, mesh).cfg.num.pressure_solver == "mg"
    d3 = Decomp3D(Grid3D(16, 16, 16), mesh, pressure_solver="mg")
    assert d3.pressure_solver == "mg"


def test_auto_resolves_to_mg_serial_and_rbsor_distributed():
    """pressure_solver='auto' = the best upgrade per run mode: mg in serial
    runs (bitwise-identical trajectory to an explicit 'mg' config) AND
    in distributed ones since parallel/mg.py landed (its coarse levels
    ride one all_gather, so the old latency-bound objection no longer
    applies); rbsor only where the global grid cannot coarsen."""
    import jax
    from jax.sharding import Mesh
    from tpuvof.parallel import Decomp, Decomp3D
    from tpuvof.solver import resolve_auto

    num = dict(sor_tol=1e-5, sor_max_iter=500)
    cfg_auto = tv.SimConfig(grid=tv.Grid2D(32, 32),
                            num=tv.Numerics(pressure_solver="auto", **num))
    cfg_mg = tv.SimConfig(grid=tv.Grid2D(32, 32),
                          num=tv.Numerics(pressure_solver="mg", **num))
    assert resolve_auto(cfg_auto) == cfg_mg
    state = tv.init_state(cfg_auto, ic=1)
    a = tv.simulate(cfg_auto, state, 3)
    b = tv.simulate(cfg_mg, state, 3)
    for x, y in zip(a, b):
        assert float(jnp.max(jnp.abs(x - y))) == 0.0

    # 3-D serial: auto == mg bitwise
    from tpuvof.grid import Grid3D
    from tpuvof.solver3d import init_state_3d, simulate_3d

    g3 = Grid3D(16, 16, 16)
    s3 = init_state_3d(g3, ic=1)
    a3 = simulate_3d(g3, s3, 2, pressure_solver="auto", **num)
    b3 = simulate_3d(g3, s3, 2, pressure_solver="mg", **num)
    for x, y in zip(a3, b3):
        assert float(jnp.max(jnp.abs(x - y))) == 0.0

    # distributed: auto -> mg where the global grid coarsens...
    mesh2 = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("mx", "my"))
    dec = Decomp(cfg_auto, mesh2)
    assert dec.cfg.num.pressure_solver == "mg"
    mesh1 = Mesh(np.array(jax.devices()[:2]), ("mx",))
    dec3 = Decomp3D(g3, mesh1, pressure_solver="auto")
    assert dec3.pressure_solver == "mg"
    # ...and rbsor on non-coarsenable grids (6 halves to 3 < 4)
    cfg6 = tv.SimConfig(grid=tv.Grid2D(6, 6),
                        num=tv.Numerics(pressure_solver="auto", **num))
    assert Decomp(cfg6, mesh2).cfg.num.pressure_solver == "rbsor"
    g6 = Grid3D(6, 6, 6)
    dec3b = Decomp3D(g6, mesh1, pressure_solver="auto")
    assert dec3b.pressure_solver == "rbsor"


def test_auto_serial_non_coarsenable_falls_back_to_rbsor():
    """VERDICT r4 bug: serial 'auto' picked mg unconditionally, so a
    non-coarsenable grid (81^2: odd extents) crashed inside mg_solve.
    resolve_auto must apply the distributed drivers' documented policy —
    mg wherever mg_levels >= 2, rbsor otherwise — and the run must
    actually work."""
    from tpuvof.solver import resolve_auto

    num = dict(pressure_solver="auto", sor_tol=1e-4, sor_max_iter=50)
    for nx, ny in ((81, 81), (200, 81)):
        # square cells (the FCT limiter requirement): Ly tracks ny/nx
        cfg = tv.SimConfig(grid=tv.Grid2D(nx, ny, Lx=0.1, Ly=0.1 * ny / nx),
                           num=tv.Numerics(**num))
        assert resolve_auto(cfg).num.pressure_solver == "rbsor"
        s0 = tv.init_state(cfg, ic=1)
        out = tv.simulate(cfg, s0, 2)  # formerly: ValueError from mg_solve
        assert bool(jnp.all(jnp.isfinite(out.F)))

    # 3-D: 9^3 is odd everywhere -> rbsor, and the run works
    from tpuvof.grid import Grid3D
    from tpuvof.solver3d import _resolve_auto_3d, init_state_3d, simulate_3d

    g9 = Grid3D(9, 9, 9)
    assert _resolve_auto_3d(g9) == "rbsor"
    s3 = init_state_3d(g9, ic=1)
    out3 = simulate_3d(g9, s3, 2, pressure_solver="auto",
                       sor_tol=1e-4, sor_max_iter=50)
    assert bool(jnp.all(jnp.isfinite(out3.F)))
