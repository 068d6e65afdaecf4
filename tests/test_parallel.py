"""Distributed (shard_map) solver must reproduce the serial trajectory.

Runs on the virtual 8-device CPU mesh (conftest). Decomposition shapes probe
1-D and 2-D tilings and both odd/even step counts.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import tpuvof as tv
from tpuvof.parallel import Decomp


def make_mesh(px, py):
    devs = np.array(jax.devices()[: px * py]).reshape(px, py)
    return Mesh(devs, ("mx", "my"))


@pytest.mark.parametrize("px,py,n_steps", [(2, 4, 9), (4, 2, 8), (1, 8, 5), (8, 1, 4), (2, 2, 6)])
def test_dist_matches_serial(px, py, n_steps):
    cfg = tv.SimConfig(grid=tv.Grid2D(16, 16))
    state = tv.init_state(cfg, ic=1)
    # run in float64 so any halo/masking bug shows above rounding noise
    state = tv.State(*(a.astype(jnp.float64) for a in state))

    serial = tv.simulate(cfg, state, n_steps)

    dec = Decomp(cfg, make_mesh(px, py))
    dist = dec.simulate(state, n_steps)

    np.testing.assert_allclose(np.asarray(dist.F)[1:-1, 1:-1],
                               np.asarray(serial.F)[1:-1, 1:-1], atol=1e-12)
    np.testing.assert_allclose(np.asarray(dist.u)[1:-1, 1:-1],
                               np.asarray(serial.u)[1:-1, 1:-1], atol=1e-12)
    np.testing.assert_allclose(np.asarray(dist.v)[1:-1, 1:-1],
                               np.asarray(serial.v)[1:-1, 1:-1], atol=1e-12)
    np.testing.assert_allclose(np.asarray(dist.p)[1:-1, 1:-1],
                               np.asarray(serial.p)[1:-1, 1:-1], atol=1e-7)


@pytest.mark.parametrize("ic", [2, 3])
def test_dist_other_ics(ic):
    cfg = tv.SimConfig(grid=tv.Grid2D(16, 16))
    state = tv.init_state(cfg, ic=ic)
    state = tv.State(*(a.astype(jnp.float64) for a in state))
    serial = tv.simulate(cfg, state, 6)
    dist = Decomp(cfg, make_mesh(2, 4)).simulate(state, 6)
    np.testing.assert_allclose(np.asarray(dist.F)[1:-1, 1:-1],
                               np.asarray(serial.F)[1:-1, 1:-1], atol=1e-12)


def test_indivisible_grid_rejected():
    cfg = tv.SimConfig(grid=tv.Grid2D(18, 18))
    with pytest.raises(ValueError, match="not divisible"):
        Decomp(cfg, make_mesh(2, 4))


def test_distributed_matches_serial_from_non_bc_consistent_state():
    """The serial driver applies apply_bc once at entry before its lean
    steps; the distributed run must do the same (it did not, and a state
    whose ghost ring is not already BC-consistent — e.g. painted or
    hand-built — diverged at ~1e-8 while the canonical ICs passed only
    because their ghosts happen to equal their mirrors)."""
    cfg = tv.SimConfig(grid=tv.Grid2D(16, 16))
    s0 = tv.init_state(cfg, ic=1)
    F = jnp.asarray(np.asarray(s0.F, np.float64))
    F = F.at[0, :].add(0.01).at[:, -1].add(-0.02)
    u = jnp.asarray(np.asarray(s0.u, np.float64)).at[0, :].add(1e-3)
    s0 = tv.State(F=F, u=u,
                  v=jnp.asarray(np.asarray(s0.v, np.float64)),
                  p=jnp.asarray(np.asarray(s0.p, np.float64)))
    want = tv.simulate(cfg, s0, 4)
    dec = Decomp(cfg, make_mesh(2, 4))
    got = dec.simulate(s0, 4)
    for name in ("F", "u", "v", "p"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name))[1:-1, 1:-1],
            np.asarray(getattr(want, name))[1:-1, 1:-1],
            atol=1e-12, err_msg=name)


def test_distributed_rbsor_matches_serial():
    """The residual-driven RB-SOR pressure solve (the framework's upgrade
    over the reference's fixed 10 Jacobi sweeps, 2dvof.py:521-522) must
    scale out (VERDICT r2 #6): per-half-sweep halo exchange, psum-mean
    nullspace projection, pmax stopping residual. Same trip count and
    values as serial to collective-reassociation noise."""
    num = tv.Numerics(pressure_solver="rbsor", sor_tol=1e-6,
                      sor_max_iter=500)
    cfg = tv.SimConfig(grid=tv.Grid2D(16, 16), num=num)
    state = tv.init_state(cfg, ic=1)
    state = tv.State(*(jnp.asarray(np.asarray(a), jnp.float64)
                       for a in state))
    want = tv.simulate(cfg, state, 5)
    got = Decomp(cfg, make_mesh(2, 4)).simulate(state, 5)
    for name in ("F", "u", "v", "p"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name))[1:-1, 1:-1],
            np.asarray(getattr(want, name))[1:-1, 1:-1],
            atol=1e-12, err_msg=name)
