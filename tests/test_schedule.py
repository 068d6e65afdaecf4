"""Chunked simulate calls must continue the reference's step schedule.

The reference runs ONE continuous istep counter: sweep parity (2-D,
2dvof.py:312-318) and the istep % 3 rotation (3-D, 3dvof.py:351-363)
depend on it. Callers that advance in chunks (the CLI frame loop,
checkpoint/resume) pass istep0 so chunk N+1 picks up exactly where chunk
N stopped; these tests pin chunked == continuous bit-for-bit (the entry
BC of the second call is idempotent on an end-of-step state).
"""
import numpy as np
import jax.numpy as jnp

import tpuvof as tv
from tpuvof.grid import Grid3D
from tpuvof.solver3d import simulate_3d


def test_simulate_2d_chunked_with_istep0_matches_continuous():
    cfg = tv.SimConfig(grid=tv.Grid2D(24, 24))
    s0 = tv.init_state(cfg, ic=1)
    s0 = tv.State(*(jnp.asarray(np.asarray(a), jnp.float64) for a in s0))
    want = tv.simulate(cfg, s0, 7)
    got = tv.simulate(cfg, tv.simulate(cfg, s0, 3), 4, istep0=3)
    for name in ("F", "u", "v", "p"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            err_msg=name)


def test_simulate_3d_chunked_with_istep0_matches_continuous():
    g = Grid3D(12, 12, 12)
    s0 = tv.init_state_3d(g, ic=1)
    s0 = tv.State3D(*(jnp.asarray(np.asarray(a), jnp.float64) for a in s0))
    want = simulate_3d(g, s0, 7)
    got = simulate_3d(g, simulate_3d(g, s0, 4), 3, istep0=4)
    for name in ("F", "u", "v", "w", "p"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            err_msg=name)


def test_distributed_istep0_continues_schedule():
    """Decomp/Decomp3D runs accept istep0 too (the CLI passes it)."""
    import jax
    from jax.sharding import Mesh
    from tpuvof.parallel import Decomp3D

    g = Grid3D(12, 12, 12)
    s0 = tv.init_state_3d(g, ic=1)
    s0 = tv.State3D(*(jnp.asarray(np.asarray(a), jnp.float64) for a in s0))
    mesh = Mesh(np.array(jax.devices()[:2]), ("mx",))
    dec = Decomp3D(g, mesh)
    want = dec.simulate(s0, 5)
    got = dec.simulate(dec.simulate(s0, 2), 3, istep0=2)
    for name in ("F", "u", "v", "w"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name))[1:-1],
            np.asarray(getattr(want, name))[1:-1], atol=1e-13, err_msg=name)


def test_distributed_2d_istep0_continues_schedule():
    import jax
    from jax.sharding import Mesh
    from tpuvof.parallel import Decomp

    cfg = tv.SimConfig(grid=tv.Grid2D(16, 16))
    s0 = tv.init_state(cfg, ic=1)
    s0 = tv.State(*(jnp.asarray(np.asarray(a), jnp.float64) for a in s0))
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("mx", "my"))
    dec = Decomp(cfg, mesh)
    want = dec.simulate(s0, 5)
    got = dec.simulate(dec.simulate(s0, 2), 3, istep0=2)
    for name in ("F", "u", "v"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name))[1:-1],
            np.asarray(getattr(want, name))[1:-1], atol=1e-13, err_msg=name)
