"""Numerical parity of the vectorized JAX ops against the loop-based spec.

Each op is compared in float64 on randomized states (tight tolerances), and
the full solver trajectory is compared over many steps for all three initial
conditions. This is the automated replacement for the reference's
manual/visual verification (SURVEY.md §4).
"""
import numpy as np
import pytest
import jax.numpy as jnp

import tpuvof as tv
from tpuvof.ops import (
    apply_bc,
    mix_properties,
    predict_velocity,
    update_velocity,
    rudman_advect,
    solve_pressure,
    young_normals_curvature,
)

from reference_numpy import RefSolver2D

NX = NY = 24
ATOL = 1e-12


def make_spec(ic=1, n_jacobi=10):
    s = RefSolver2D(NX, NY, n_jacobi=n_jacobi, dtype=np.float64)
    s.set_init_F(ic)
    return s


def make_cfg(n_jacobi=10):
    return tv.SimConfig(
        grid=tv.Grid2D(NX, NY), num=tv.Numerics(n_jacobi=n_jacobi)
    )


def random_fields(rng, spec):
    """Load a randomized but BC-consistent state into the spec solver."""
    shape = (NX + 2, NY + 2)
    spec.F = np.clip(rng.normal(0.5, 0.4, shape), 0, 1)
    spec.u = rng.normal(0, 1e-3, shape)
    spec.v = rng.normal(0, 1e-3, shape)
    spec.p = rng.normal(0, 10.0, shape)
    spec.cal_nu_rho()
    spec.set_BC()
    return spec


def test_materials():
    rng = np.random.default_rng(0)
    spec = random_fields(rng, make_spec())
    cfg = make_cfg()
    rho, nu = mix_properties(cfg.fluid, jnp.asarray(spec.F))
    spec.cal_nu_rho()
    np.testing.assert_allclose(np.asarray(rho), spec.rho, atol=ATOL)
    np.testing.assert_allclose(np.asarray(nu), spec.nu, atol=ATOL)


def test_bc():
    rng = np.random.default_rng(1)
    shape = (NX + 2, NY + 2)
    spec = make_spec()
    spec.F = rng.normal(size=shape)
    spec.u = rng.normal(size=shape)
    spec.v = rng.normal(size=shape)
    spec.p = rng.normal(size=shape)
    spec.rho = rng.normal(size=shape)
    u, v, F, p, rho = apply_bc(
        *(jnp.asarray(a) for a in (spec.u, spec.v, spec.F, spec.p, spec.rho))
    )
    spec.set_BC()
    for got, want in [(u, spec.u), (v, spec.v), (F, spec.F), (p, spec.p), (rho, spec.rho)]:
        np.testing.assert_allclose(np.asarray(got), want, atol=ATOL)


def test_normals_curvature():
    rng = np.random.default_rng(2)
    spec = random_fields(rng, make_spec())
    cfg = make_cfg()
    mx, my, kappa = young_normals_curvature(cfg.grid, jnp.asarray(spec.F))
    spec.get_normal_young()
    np.testing.assert_allclose(np.asarray(mx), spec.mx, atol=1e-10)
    np.testing.assert_allclose(np.asarray(my), spec.my, atol=1e-10)
    np.testing.assert_allclose(np.asarray(kappa), spec.kappa, atol=1e-7)


def test_momentum_predictor():
    rng = np.random.default_rng(3)
    spec = random_fields(rng, make_spec())
    spec.get_normal_young()
    cfg = make_cfg()
    us, vs = predict_velocity(
        cfg.grid,
        cfg.fluid,
        cfg.num,
        *(jnp.asarray(a) for a in (spec.u, spec.v, spec.F, spec.rho, spec.nu, spec.kappa)),
    )
    spec.advect_upwind()
    np.testing.assert_allclose(np.asarray(us), spec.u_star, atol=1e-12)
    np.testing.assert_allclose(np.asarray(vs), spec.v_star, atol=1e-12)


def test_pressure_jacobi():
    rng = np.random.default_rng(4)
    spec = random_fields(rng, make_spec())
    spec.get_normal_young()
    spec.advect_upwind()
    spec.set_BC()
    cfg = make_cfg()
    p = solve_pressure(
        cfg.grid,
        cfg.num,
        *(jnp.asarray(a) for a in (spec.p, spec.u_star, spec.v_star, spec.rho)),
    )
    for _ in range(10):
        spec.solve_p_jacobi()
    np.testing.assert_allclose(np.asarray(p), spec.p, atol=1e-6)


def test_velocity_correction():
    rng = np.random.default_rng(5)
    spec = random_fields(rng, make_spec())
    spec.u_star = np.random.default_rng(6).normal(0, 1e-3, spec.u.shape)
    spec.v_star = np.random.default_rng(7).normal(0, 1e-3, spec.v.shape)
    cfg = make_cfg()
    u, v = update_velocity(
        cfg.grid,
        cfg.num,
        *(jnp.asarray(a) for a in (spec.u, spec.v, spec.u_star, spec.v_star, spec.p, spec.rho)),
    )
    spec.update_uv()
    np.testing.assert_allclose(np.asarray(u), spec.u, atol=1e-12)
    np.testing.assert_allclose(np.asarray(v), spec.v, atol=1e-12)


@pytest.mark.parametrize("parity", [0, 1])
def test_fct_double_sweep(parity):
    rng = np.random.default_rng(8 + parity)
    spec = random_fields(rng, make_spec())
    cfg = make_cfg()
    F = rudman_advect(
        cfg.grid,
        cfg.num,
        jnp.asarray(spec.F),
        jnp.asarray(spec.u),
        jnp.asarray(spec.v),
        even_step=(parity == 0),
    )
    spec.solve_VOF_rudman(parity)
    np.testing.assert_allclose(np.asarray(F), spec.F, atol=1e-12)


@pytest.mark.parametrize("ic,n_steps", [(1, 30), (2, 14), (3, 14)])
def test_trajectory_f64(ic, n_steps):
    """Full-solver trajectory parity over tens of steps (float64).
    Tolerances allow XLA re-association noise to amplify slightly."""
    spec = make_spec(ic)
    cfg = make_cfg()
    state = tv.State(
        F=jnp.asarray(spec.F),
        u=jnp.asarray(spec.u),
        v=jnp.asarray(spec.v),
        p=jnp.asarray(spec.p),
    )
    state = tv.simulate(cfg, state, n_steps)
    spec.run(n_steps)
    np.testing.assert_allclose(np.asarray(state.F), spec.F, atol=1e-9)
    np.testing.assert_allclose(np.asarray(state.u), spec.u, atol=1e-9)
    np.testing.assert_allclose(np.asarray(state.v), spec.v, atol=1e-9)
    np.testing.assert_allclose(np.asarray(state.p), spec.p, atol=1e-5)


def test_trajectory_f32():
    """The production dtype stays within f32-noise of the spec short-term."""
    n_steps = 20
    spec = RefSolver2D(NX, NY, dtype=np.float32)
    spec.set_init_F(1)
    cfg = make_cfg()
    state = tv.init_state(cfg, ic=1)
    state = tv.simulate(cfg, state, n_steps)
    spec.run(n_steps)
    assert np.max(np.abs(np.asarray(state.F) - spec.F)) < 1e-4


def test_rbsor_beats_fixed_jacobi():
    """The RB-SOR upgrade reaches a far smaller residual than the
    reference's fixed 10 Jacobi sweeps, and the solver stays stable on it."""
    import jax.numpy as jnp
    from tpuvof.ops.poisson import divergence_rhs, residual, solve_pressure

    rng = np.random.default_rng(11)
    spec = random_fields(rng, make_spec())
    spec.get_normal_young()
    spec.advect_upwind()
    spec.set_BC()
    cfg_j = make_cfg()
    cfg_s = tv.SimConfig(
        grid=tv.Grid2D(NX, NY),
        num=tv.Numerics(pressure_solver="rbsor", sor_tol=1e-6, sor_max_iter=2000),
    )
    args = tuple(jnp.asarray(a) for a in (spec.p, spec.u_star, spec.v_star, spec.rho))
    rhs = divergence_rhs(cfg_j.grid, cfg_j.num, args[1], args[2], args[3])
    rhs0 = rhs - jnp.mean(rhs)  # solvable part (rbsor solves against this)
    p_j = solve_pressure(cfg_j.grid, cfg_j.num, *args)
    p_s = solve_pressure(cfg_s.grid, cfg_s.num, *args)
    r_j = float(residual(cfg_j.grid, p_j, rhs0, project_nullspace=False))
    r_s = float(residual(cfg_s.grid, p_s, rhs0, project_nullspace=False))
    assert r_s < 1e-5 * r_j, (r_j, r_s)

    # full solver remains bounded with the rbsor pressure solve
    state = tv.init_state(cfg_s, ic=1)
    state = tv.simulate(cfg_s, state, 20)
    F = np.asarray(state.F)
    assert np.isfinite(F).all() and F.min() >= 0 and F.max() <= 1
