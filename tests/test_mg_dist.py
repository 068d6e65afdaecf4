"""Distributed geometric multigrid (parallel/mg.py) vs the serial solver.

Runs on the virtual 8-device CPU mesh (conftest). Two layers of parity:

  1. the ISOLATED solve: mg_solve_dist inside shard_map against
     ops.mg.mg_solve on the gathered problem, across 1-D/2-D tilings and
     all three crossover regimes (fully replicated L=0, mixed, fully
     distributed) by overriding ``gather_volume``;
  2. the FULL STEP: Decomp / Decomp3D with pressure_solver='mg' against
     the serial trajectory at f64 (the same 1e-12-class contract as the
     rbsor tests — trip counts match because residual/scale reductions
     are global psum/pmax).

The reference has no counterpart at any scale (its solvers are fixed-sweep
Jacobi, reference 2dvof.py:521, 3dvof.py:334-349).
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

import tpuvof as tv
from tpuvof.grid import Grid3D
from tpuvof.ops.mg import mg_solve
from tpuvof.parallel import Decomp, Decomp3D
from tpuvof.parallel.mg import MGDecomp, mg_solve_dist
import tpuvof.parallel.mg as pmg


def make_mesh(px, py):
    devs = np.array(jax.devices()[: px * py]).reshape(px, py)
    return Mesh(devs, ("mx", "my"))


def _manufactured(shape, seed=0):
    """A zero-mean rhs with structure at several wavelengths."""
    rng = np.random.default_rng(seed)
    rhs = rng.standard_normal(shape)
    for ax, n in enumerate(shape):
        x = np.arange(n) / n
        wave = np.sin(2 * np.pi * x) + 0.3 * np.cos(6 * np.pi * x)
        rhs += np.expand_dims(
            wave, tuple(k for k in range(len(shape)) if k != ax))
    rhs -= rhs.mean()
    return jnp.asarray(rhs, jnp.float64)


def _solve_dist(mesh_shape, gshape, gather_volume, tol=1e-9, tol_rel=0.0):
    """Run serial and distributed solves on the same problem; return both
    interior solutions as numpy."""
    nd = len(gshape)
    inv2 = tuple(float((n / 1.0) ** 2) for n in gshape)  # unit box
    rhs = _manufactured(gshape)
    pg = jnp.zeros(tuple(n + 2 for n in gshape), jnp.float64)
    out_s = mg_solve(pg, rhs, inv2, tol, 80, tol_rel=tol_rel)

    px, py = mesh_shape
    mesh = make_mesh(px, py)
    shards = (px, py) + (1,) * (nd - 2)
    spec = MGDecomp(
        axis_names=tuple(
            ("mx", "my")[ax] if shards[ax] > 1 else None
            for ax in range(nd)),
        shards=shards)
    pspec = P(*(("mx", "my")[ax] if shards[ax] > 1 else None
                for ax in range(nd)))

    def local(rhs_l):
        p_l = jnp.pad(jnp.zeros_like(rhs_l), 1)
        out = mg_solve_dist(spec, p_l, rhs_l, inv2, tol, 80,
                            tol_rel=tol_rel, gather_volume=gather_volume)
        return out[(slice(1, -1),) * nd]

    f = jax.shard_map(local, mesh=mesh, in_specs=pspec, out_specs=pspec)
    out_d = f(rhs)
    interior = (slice(1, -1),) * nd
    return np.asarray(out_s[interior]), np.asarray(out_d)


# gather_volume regimes on a 32^2 / 16^3 ladder:
#   10**9 -> L=0 (fully replicated: one gather, serial solve, slice back)
#   0     -> fully distributed (sharded down to the coarsest level)
#   256   -> mixed (fine levels sharded, tail replicated)
@pytest.mark.parametrize("gv", [10**9, 0, 256])
@pytest.mark.parametrize("px,py", [(2, 4), (8, 1), (1, 8), (2, 2)])
def test_solve_matches_serial_2d(px, py, gv):
    s, d = _solve_dist((px, py), (32, 32), gv)
    np.testing.assert_allclose(d, s, atol=1e-11)


@pytest.mark.parametrize("gv", [10**9, 0, 256])
@pytest.mark.parametrize("px,py", [(2, 4), (4, 1)])
def test_solve_matches_serial_3d(px, py, gv):
    s, d = _solve_dist((px, py), (16, 16, 16), gv)
    np.testing.assert_allclose(d, s, atol=1e-11)


def test_solve_matches_serial_tolrel():
    """sor_tol_rel's scale is a GLOBAL pmax, so the relative stop takes
    the same trip count as serial (identical result, not just close)."""
    s, d = _solve_dist((2, 4), (32, 32), 256, tol=1e-12, tol_rel=1e-3)
    np.testing.assert_allclose(d, s, atol=1e-11)


def test_step_dist_mg_matches_serial_2d():
    """Full Decomp trajectory with pressure_solver='mg' == serial at f64
    — including the post-solve ghost refresh the velocity correction
    reads at shard boundaries."""
    num = tv.Numerics(pressure_solver="mg", sor_tol=1e-8, sor_max_iter=60)
    cfg = tv.SimConfig(grid=tv.Grid2D(16, 16), num=num)
    state = tv.init_state(cfg, ic=1)
    state = tv.State(*(a.astype(jnp.float64) for a in state))
    serial = tv.simulate(cfg, state, 6)
    for px, py in [(2, 4), (8, 1)]:
        dist = Decomp(cfg, make_mesh(px, py)).simulate(state, 6)
        for a, b, tol in [(dist.F, serial.F, 1e-12),
                          (dist.u, serial.u, 1e-12),
                          (dist.v, serial.v, 1e-12),
                          (dist.p, serial.p, 1e-10)]:
            np.testing.assert_allclose(np.asarray(a)[1:-1, 1:-1],
                                       np.asarray(b)[1:-1, 1:-1], atol=tol)


def test_step_dist3d_mg_matches_serial(monkeypatch):
    """Full Decomp3D trajectory with mg == serial at f64, with the
    crossover forced low so SHARDED smoothing levels are exercised."""
    from tpuvof.solver3d import init_state_3d, simulate_3d

    monkeypatch.setattr(pmg, "GATHER_VOLUME", 64)
    g = Grid3D(16, 16, 16)
    state = init_state_3d(g, ic=1)
    state = type(state)(*(a.astype(jnp.float64) for a in state))
    kw = dict(pressure_solver="mg", sor_tol=1e-8, sor_max_iter=60)
    serial = simulate_3d(g, state, 4, **kw)
    I = (slice(1, -1),) * 3
    for px, py in [(2, 4), (4, 1)]:
        dist = Decomp3D(g, make_mesh(px, py), **kw).simulate(state, 4)
        np.testing.assert_allclose(np.asarray(dist.F)[I],
                                   np.asarray(serial.F)[I], atol=1e-12)
        np.testing.assert_allclose(np.asarray(dist.u)[I],
                                   np.asarray(serial.u)[I], atol=1e-12)
        np.testing.assert_allclose(np.asarray(dist.p)[I],
                                   np.asarray(serial.p)[I], atol=1e-10)


def test_non_coarsenable_global_grid_raises():
    """The coarsenability contract is on the GLOBAL grid (the local block
    may be a single row of it). 6 halves to 3 < 4, so (6,6) has no
    coarse level at all."""
    num = tv.Numerics(pressure_solver="mg")
    cfg = tv.SimConfig(grid=tv.Grid2D(6, 6), num=num)
    dec = Decomp(cfg, make_mesh(2, 1))
    state = tv.init_state(cfg, ic=1)
    with pytest.raises(ValueError, match="coarsenable"):
        dec.simulate(state, 1)
