"""x-decomposed 3-D solver vs the serial path at f64 (VERDICT r1 #7).

Runs on the virtual 8-device CPU mesh (tests/conftest.py). The distributed
trajectory must match the serial solver to re-association noise: same
grid, same schedule, halo exchanges standing in for the serial array's
contiguity.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import tpuvof as tv
from tpuvof.grid import Grid3D
from tpuvof.solver3d import simulate_3d
from tpuvof.parallel import Decomp3D

N = 16


def make_mesh_1d(px):
    devs = jax.devices()[:px]
    return Mesh(np.array(devs), ("mx",))


def _f64(state):
    return tv.State3D(*(jnp.asarray(np.asarray(a), jnp.float64) for a in state))


@pytest.mark.parametrize("px", [2, 4, 8])
def test_distributed_3d_matches_serial(px):
    g = Grid3D(N, N, N)
    state = _f64(tv.init_state_3d(g, ic=1))
    n_steps = 5  # covers phases 1, 2, 0, 1, 2 (incl. the x-sweep first/last)
    want = simulate_3d(g, state, n_steps)
    dec = Decomp3D(g, make_mesh_1d(px))
    got = dec.simulate(state, n_steps)
    np.testing.assert_allclose(np.asarray(got.F)[1:-1], np.asarray(want.F)[1:-1],
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(got.u)[1:-1], np.asarray(want.u)[1:-1],
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(got.v)[1:-1], np.asarray(want.v)[1:-1],
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(got.w)[1:-1], np.asarray(want.w)[1:-1],
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(got.p)[1:-1], np.asarray(want.p)[1:-1],
                               atol=1e-8)


def test_distributed_3d_longer_run_physics():
    g = Grid3D(N, N, N)
    state = tv.init_state_3d(g, ic=1)
    dec = Decomp3D(g, make_mesh_1d(4))
    out = dec.simulate(state, 12)
    F = np.asarray(out.F)
    m0 = float(np.asarray(state.F)[1:-1, 1:-1, 1:-1].sum())
    assert np.isfinite(F).all()
    assert F.min() >= 0.0 and F.max() <= 1.0
    assert abs(F[1:-1, 1:-1, 1:-1].sum() - m0) / m0 < 1e-3


def test_decomp3d_rejects_bad_mesh():
    g = Grid3D(10, 10, 10)
    with pytest.raises(ValueError, match="divisible"):
        Decomp3D(g, make_mesh_1d(4))


def make_mesh_2d(px, py):
    devs = np.array(jax.devices()[: px * py]).reshape(px, py)
    return Mesh(devs, ("mx", "my"))


@pytest.mark.parametrize("px,py,n_steps", [(2, 2, 5), (2, 4, 4), (4, 2, 3),
                                           (1, 2, 4)])
def test_distributed_3d_two_axis_matches_serial(px, py, n_steps):
    """(x, y)-pencil decomposition (2-axis mesh, XLA engine): the masked
    global-index sweeps (ops/fct3d.sweep_masked_2axis), two-stage corner
    exchanges, and the v_lo=1 predictor faces must reproduce the serial
    trajectory like the x-slab engine does. Step counts cover all three
    istep%3 phases; (1,2) exercises the y-only degenerate mesh."""
    g = Grid3D(N, N, N)
    state = _f64(tv.init_state_3d(g, ic=1))
    want = simulate_3d(g, state, n_steps)
    dec = Decomp3D(g, make_mesh_2d(px, py))
    got = dec.simulate(state, n_steps)
    for name, atol in (("F", 1e-12), ("u", 1e-12), ("v", 1e-12),
                       ("w", 1e-12), ("p", 1e-8)):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name))[1:-1, 1:-1],
            np.asarray(getattr(want, name))[1:-1, 1:-1], atol=atol,
            err_msg=f"{name} {px}x{py}")


def test_distributed_3d_pencil_from_non_bc_consistent_state():
    """A state whose ghost planes are NOT mirror-consistent (painted/
    hand-built) must track the serial path on a 2x2 pencil mesh: both
    run the reference's step order, whose predictor reads the RAW entry
    ghosts before the first set_BC — the canonical ICs pass trivially
    because their ghosts equal their mirrors. 2-D twin:
    tests/test_parallel.py::test_distributed_matches_serial_from_non_bc_consistent_state."""
    g = Grid3D(32, 32, 32)
    s = _f64(tv.init_state_3d(g, ic=1))
    F = s.F.at[0, :, :].add(0.01).at[:, -1, :].add(-0.02)
    u = s.u.at[:, 0, :].add(1e-3)
    s0 = tv.State3D(F=F, u=u, v=s.v, w=s.w, p=s.p)
    n_steps = 3
    want = simulate_3d(g, s0, n_steps, n_jacobi=2)
    got = Decomp3D(g, make_mesh_2d(2, 2), n_jacobi=2).simulate(s0, n_steps)
    for name, atol in (("F", 1e-12), ("u", 1e-12), ("v", 1e-12),
                       ("w", 1e-12), ("p", 1e-8)):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name))[1:-1, 1:-1],
            np.asarray(getattr(want, name))[1:-1, 1:-1], atol=atol,
            err_msg=name)


def test_distributed_3d_rbsor_matches_serial():
    """The 3-D residual-driven RB-SOR (the framework's numerics upgrade
    over the reference's fixed 10 sweeps, 3dvof.py:598-623) must scale
    out like the 2-D one (VERDICT r2 #6): per-half-sweep exchanges +
    psum/pmax residual give every shard the identical trip count, so a
    2x2-pencil XLA-engine run matches serial rbsor at f64 tolerance."""
    g = Grid3D(N, N, N)
    state = _f64(tv.init_state_3d(g, ic=1))
    n_steps = 4
    kw = dict(pressure_solver="rbsor", sor_tol=1e-6, sor_max_iter=2000)
    want = simulate_3d(g, state, n_steps, **kw)
    dec = Decomp3D(g, make_mesh_2d(2, 2), **kw)
    got = dec.simulate(state, n_steps)
    for name, atol in (("F", 1e-12), ("u", 1e-12), ("v", 1e-12),
                       ("w", 1e-12), ("p", 1e-8)):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name))[1:-1, 1:-1],
            np.asarray(getattr(want, name))[1:-1, 1:-1], atol=atol,
            err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_distributed_3d_pencil_fuzz(seed):
    """Randomized-state fuzz of the pencil decomposition vs the serial
    path, f64 on a 2x2 mesh: random (BC-consistent) fields leave no
    structure for a mask/halo/corner bug to hide behind; 3 steps cover
    all sweep phases."""
    from test_3d import _random_3d_state

    g = Grid3D(32, 32, 32)
    rng = np.random.default_rng(40 + seed)
    state = tv.State3D(*(jnp.asarray(np.asarray(a), jnp.float64)
                         for a in _random_3d_state(g, rng)))
    n_steps = 3
    want = simulate_3d(g, state, n_steps, n_jacobi=2)
    got = Decomp3D(g, make_mesh_2d(2, 2), n_jacobi=2).simulate(state,
                                                               n_steps)
    for name, atol in (("F", 1e-12), ("u", 1e-12), ("v", 1e-12),
                       ("w", 1e-12), ("p", 1e-8)):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name))[1:-1, 1:-1],
            np.asarray(getattr(want, name))[1:-1, 1:-1], atol=atol,
            err_msg=f"{name} seed{seed}")


@pytest.mark.parametrize("px", [2, 4])
def test_distributed_3d_csf_matches_serial(px):
    """Distributed 3-D surface tension (VERDICT r3 #1b): the XLA engine's
    normals/curvature exchanges reproduce the serial csf trajectory at
    f64 — including across shard boundaries, where kappa's +-3 F cone
    spans three shards at px=4 (N/px = 4 owned planes)."""
    g = Grid3D(N, N, N)
    state = _f64(tv.init_state_3d(g, ic=1))
    n_steps = 5
    want = simulate_3d(g, state, n_steps, csf=True)
    dec = Decomp3D(g, make_mesh_1d(px), csf=True)
    got = dec.simulate(state, n_steps)
    # csf really engaged: trajectories must differ from csf=False
    base = simulate_3d(g, state, n_steps)
    assert float(jnp.max(jnp.abs(want.u - base.u))) > 0.0
    for name, atol in (("F", 1e-12), ("u", 1e-12), ("v", 1e-12),
                       ("w", 1e-12), ("p", 1e-8)):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name))[1:-1],
            np.asarray(getattr(want, name))[1:-1], atol=atol,
            err_msg=name)


def test_distributed_3d_csf_two_axis_xla_matches_serial():
    """csf on the 2-axis XLA engine: the normals/curvature exchanges run
    in BOTH decomposed axes (x-then-y stages inside _exchange)."""
    g = Grid3D(N, N, N)
    state = _f64(tv.init_state_3d(g, ic=1))
    n_steps = 4
    want = simulate_3d(g, state, n_steps, csf=True)
    got = Decomp3D(g, make_mesh_2d(2, 2), csf=True).simulate(state,
                                                             n_steps)
    for name, atol in (("F", 1e-12), ("u", 1e-12), ("v", 1e-12),
                       ("w", 1e-12), ("p", 1e-8)):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name))[1:-1, 1:-1],
            np.asarray(getattr(want, name))[1:-1, 1:-1], atol=atol,
            err_msg=name)
