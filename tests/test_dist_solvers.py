"""The residual-driven pressure solvers (rbsor, mg) through the
distributed drivers, against the serial solver at f64 on the mesh layouts
that test_parallel*.py and test_mg_dist.py do not already pin: the 1x1
mesh (shard machinery, no collectives), the 1x8 row split, the 2x2 block
in 2-D, and the 1x1 slab, 2-slab and 2x2-pencil layouts in 3-D.

Runs on the virtual 8-device CPU mesh (tests/conftest.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import tpuvof as tv
from tpuvof.grid import Grid3D
from tpuvof.parallel import Decomp, Decomp3D
from tpuvof.solver3d import simulate_3d

SOLVE = dict(sor_tol=1e-8, sor_max_iter=2000)


def mesh_2d(px, py):
    return Mesh(np.array(jax.devices()[: px * py]).reshape(px, py),
                ("mx", "my"))


def mesh_1d(px):
    return Mesh(np.array(jax.devices()[:px]), ("mx",))


def _f64(state):
    return type(state)(*(jnp.asarray(np.asarray(a), jnp.float64)
                         for a in state))


def _check(got, want, fields, atol_p):
    I = (slice(1, -1),) * np.asarray(got.F).ndim
    for f in fields:
        np.testing.assert_allclose(np.asarray(getattr(got, f))[I],
                                   np.asarray(getattr(want, f))[I],
                                   atol=atol_p if f == "p" else 1e-12,
                                   err_msg=f)


@pytest.mark.parametrize("solver", ["rbsor", "mg"])
@pytest.mark.parametrize("px,py,n", [(1, 1, 16), (1, 8, 32), (2, 2, 16)])
def test_decomp_solver_matches_serial(solver, px, py, n):
    """7 steps (both sweep parities, an odd tail) of Decomp with the
    upgraded solver == serial at f64: psum/pmax reductions give every
    shard the serial trip count."""
    cfg = tv.SimConfig(grid=tv.Grid2D(n, n),
                       num=tv.Numerics(pressure_solver=solver, **SOLVE))
    state = _f64(tv.init_state(cfg, ic=1))
    want = tv.simulate(cfg, state, 7)
    got = Decomp(cfg, mesh_2d(px, py)).simulate(state, 7)
    _check(got, want, ("F", "u", "v", "p"), 1e-7)


@pytest.mark.parametrize("solver", ["rbsor", "mg"])
@pytest.mark.parametrize("mesh_fn", [lambda: mesh_1d(1), lambda: mesh_1d(2),
                                     lambda: mesh_2d(2, 2)],
                         ids=["1x1-slab", "2-slab", "2x2-pencil"])
def test_decomp3d_solver_matches_serial(solver, mesh_fn):
    """4 steps (phases 1, 2, 0, 1: every sweep order and a wrap) of
    Decomp3D with the upgraded solver == serial at f64."""
    g = Grid3D(16, 16, 16)
    state = _f64(tv.init_state_3d(g, ic=1))
    want = simulate_3d(g, state, 4, pressure_solver=solver, **SOLVE)
    got = Decomp3D(g, mesh_fn(), pressure_solver=solver,
                   **SOLVE).simulate(state, 4)
    _check(got, want, ("F", "u", "v", "w", "p"), 1e-7)


MG_REL = dict(pressure_solver="mg", sor_tol=0.0, sor_tol_rel=1e-2,
              sor_max_iter=50)


@pytest.mark.parametrize("mesh_fn", [lambda: mesh_2d(1, 1),
                                     lambda: mesh_2d(2, 1),
                                     lambda: mesh_2d(1, 2)],
                         ids=["1x1", "2x1", "1x2"])
def test_decomp_mg_sharded_levels_on_size1_mesh_axes(mesh_fn, monkeypatch):
    """Production mg (relative tolerance) with every V-cycle level run
    sharded, on meshes with size-1 axes: the residual reductions run over
    every mesh axis, so the while_loop carries stay mesh-invariant and
    the trip counts match serial."""
    from tpuvof.parallel import mg as pmg

    monkeypatch.setattr(pmg, "GATHER_VOLUME", 16)
    cfg = tv.SimConfig(grid=tv.Grid2D(32, 32), num=tv.Numerics(**MG_REL))
    state = _f64(tv.init_state(cfg, ic=1))
    want = tv.simulate(cfg, state, 5)
    got = Decomp(cfg, mesh_fn()).simulate(state, 5)
    _check(got, want, ("F", "u", "v", "p"), 1e-7)


@pytest.mark.parametrize("mesh_fn", [lambda: mesh_1d(1),
                                     lambda: mesh_2d(2, 1)],
                         ids=["1-slab", "2x1-pencil-mesh"])
def test_decomp3d_mg_sharded_levels_on_size1_mesh_axes(mesh_fn, monkeypatch):
    """The 3-D twin: Decomp3D mg at relative tolerance, levels sharded."""
    from tpuvof.parallel import mg as pmg

    monkeypatch.setattr(pmg, "GATHER_VOLUME", 16)
    g = Grid3D(16, 16, 16)
    state = _f64(tv.init_state_3d(g, ic=1))
    want = simulate_3d(g, state, 4, **MG_REL)
    got = Decomp3D(g, mesh_fn(), **MG_REL).simulate(state, 4)
    _check(got, want, ("F", "u", "v", "w", "p"), 1e-7)
