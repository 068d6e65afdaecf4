"""3-D surface tension (ops/normals3d.py, the opt-in CSF upgrade).

The reference DISABLES 3-D surface tension — its normals kernel is
commented out (3dvof.py:304-332) and kappa is never written (3dvof.py:607)
— so there is no oracle to pin against. The contract here is instead:

  1. extrusion parity: on a z-invariant volume the 3-D Youngs normals and
     Brackbill curvature reduce EXACTLY to the pinned 2-D op
     (ops/normals.py, itself parity-locked to 2dvof.py:283-309);
  2. axis equivariance: permuting the volume's axes permutes the normals;
  3. degeneracy guard: uniform F keeps raw (zero) components, and the
     NaN-safe normalization stays differentiable (same contract as 2-D);
  4. default-off reference parity: csf=False (the default) and sigma=0
     with csf=True both reproduce the inert-kappa step bit-for-bit;
  5. the enabled step stays finite/bounded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpuvof as tv
from tpuvof.grid import Grid2D, Grid3D
from tpuvof.ops.normals import young_normals_curvature
from tpuvof.ops.normals3d import (young_normals_3d,
                                  young_normals_curvature_3d)
from tpuvof.solver3d import init_state_3d, simulate_3d


def _extruded_dam_break(n):
    """(g2, F2, g3, F3): a 2-D dam-break F and its z-invariant extrusion
    (ghost layers included — z-invariance must hold on every k slice)."""
    cfg = tv.SimConfig(grid=tv.Grid2D(n, n))
    # evolve a few steps so the interface has genuine curvature
    state = tv.simulate(cfg, tv.init_state(cfg, ic=1), 40)
    F2 = jnp.asarray(np.asarray(state.F), jnp.float64)
    F3 = jnp.broadcast_to(F2[:, :, None], (n + 2, n + 2, n + 2))
    return cfg.grid, F2, Grid3D(n, n, n), F3


def test_extrusion_parity_with_2d_op():
    g2, F2, g3, F3 = _extruded_dam_break(24)
    mx2, my2, kap2 = young_normals_curvature(g2, F2)
    mx3, my3, mz3, kap3 = young_normals_curvature_3d(g3, F3)

    # mz vanishes EXACTLY (every z-difference subtracts identical values)
    assert float(jnp.max(jnp.abs(mz3))) == 0.0

    # each interior k-slice reproduces the 2-D fields (f64; the 8-corner
    # mean sums the four distinct corner gradients twice, so only
    # summation order differs from the 2-D op)
    for k in (1, 12, 24):
        np.testing.assert_allclose(np.asarray(mx3[:, :, k]),
                                   np.asarray(mx2), atol=1e-13)
        np.testing.assert_allclose(np.asarray(my3[:, :, k]),
                                   np.asarray(my2), atol=1e-13)
        np.testing.assert_allclose(np.asarray(kap3[:, :, k]),
                                   np.asarray(kap2), atol=1e-10)

    # ghost layers are never written (zero ghosts, the 2-D convention)
    for a in (mx3, my3, mz3, kap3):
        arr = np.asarray(a)
        assert np.all(arr[0] == 0) and np.all(arr[-1] == 0)
        assert np.all(arr[:, 0] == 0) and np.all(arr[:, -1] == 0)
        assert np.all(arr[:, :, 0] == 0) and np.all(arr[:, :, -1] == 0)


def test_axis_equivariance():
    rng = np.random.default_rng(7)
    n = 12
    g = Grid3D(n, n, n)
    F = jnp.asarray(rng.random((n + 2, n + 2, n + 2)))
    mx, my, mz, kap = young_normals_curvature_3d(g, F)
    # permute x<->z: normals permute components, curvature is invariant
    Fp = jnp.transpose(F, (2, 1, 0))
    pmx, pmy, pmz, pkap = young_normals_curvature_3d(g, Fp)
    np.testing.assert_allclose(np.asarray(pmx),
                               np.asarray(jnp.transpose(mz, (2, 1, 0))),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(pmy),
                               np.asarray(jnp.transpose(my, (2, 1, 0))),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(pmz),
                               np.asarray(jnp.transpose(mx, (2, 1, 0))),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(pkap),
                               np.asarray(jnp.transpose(kap, (2, 1, 0))),
                               atol=1e-10)


def test_degeneracy_guard_and_grad_safety():
    n = 8
    g = Grid3D(n, n, n)
    F = jnp.ones((n + 2, n + 2, n + 2))  # uniform: all gradients zero
    mx, my, mz, kap = young_normals_curvature_3d(g, F)
    for a in (mx, my, mz, kap):
        assert float(jnp.max(jnp.abs(a))) == 0.0

    # NaN-safe normalization: grad through a degenerate field is finite
    # (the 2-D op's autodiff contract, ops/normals.py docstring)
    grad = jax.grad(lambda f: jnp.sum(young_normals_3d(g, f)[0] ** 2))(F)
    assert bool(jnp.all(jnp.isfinite(grad)))


def test_sigma_zero_bit_parity_and_default_off():
    n = 12
    g = Grid3D(n, n, n)
    state = init_state_3d(g, ic=1)
    base = simulate_3d(g, state, 4)
    # default csf=False is the same call signature as before the upgrade
    off = simulate_3d(g, state, 4, csf=False)
    for a, b in zip(base, off):
        assert float(jnp.max(jnp.abs(a - b))) == 0.0
    # sigma=0 makes the CSF force identically zero -> bit parity
    zero_sigma = simulate_3d(g, state, 4, fl=tv.Fluid(sigma=0.0), csf=True)
    base0 = simulate_3d(g, state, 4, fl=tv.Fluid(sigma=0.0))
    for a, b in zip(zero_sigma, base0):
        assert float(jnp.max(jnp.abs(a - b))) == 0.0


def test_csf_step_bounded_and_distinct():
    n = 16
    g = Grid3D(n, n, n)
    state = init_state_3d(g, ic=1)
    on = simulate_3d(g, state, 6, csf=True)
    off = simulate_3d(g, state, 6)
    F = np.asarray(on.F)
    assert np.all(np.isfinite(F))
    assert F.min() >= 0.0 and F.max() <= 1.0
    # mass is conserved by the FCT advection regardless of the momentum
    # source terms
    assert abs(F[1:-1, 1:-1, 1:-1].sum()
               - np.asarray(off.F)[1:-1, 1:-1, 1:-1].sum()) < 1e-8
    # and the force actually does something (default sigma=0.007)
    assert float(jnp.max(jnp.abs(on.u - off.u))) > 0.0


@pytest.mark.parametrize("istep2,istep3", [(1, 0), (0, 1)])
def test_extruded_trajectory_oracle_csf(istep2, istep3):
    """STEPPED-PHYSICS oracle (the op-level extrusion parity above pins
    only the normals op): one 3-D csf step on a z-invariant extruded
    state with w=0 equals the independently-pinned 2-D csf step
    slice-for-slice, when the pressure is solved to convergence (rbsor,
    tight tol — the fixed-iteration Jacobi's k-dependent edge
    coefficients make its unconverged iterates z-VARIANT, so only a
    converged solve admits this oracle).

    Sweep-order pairing: the 3-D istep%3 rotation vs the 2-D parity
    alternation — with the z-sweep an exact identity at w=0, 3-D phase 1
    (y,z,x) pairs with the 2-D even step (y,x) and phase 2 (z,x,y) with
    the odd step (x,y). p is compared via its gradient only (each solver
    fixes the nullspace constant differently); the FCT scale factors are
    mathematically equal but FP-rounded differently (dy*dz/vol vs
    dy/(dx*dy)), hence the 1e-10 tolerances rather than bitwise."""
    n = 24
    num = tv.Numerics(pressure_solver="rbsor", sor_tol=1e-6,
                      sor_max_iter=100_000)
    cfg = tv.SimConfig(grid=tv.Grid2D(n, n), num=num)
    s0 = tv.init_state(cfg, ic=1)
    s0 = tv.State(*(jnp.asarray(np.asarray(a), jnp.float64) for a in s0))
    warm = tv.simulate(cfg, s0, 40)  # genuine curvature + velocity field

    def ext(a2):
        return jnp.broadcast_to(a2[:, :, None], (n + 2, n + 2, n + 2))

    g3 = Grid3D(n, n, n)
    state3 = tv.State3D(F=ext(warm.F), u=ext(warm.u), v=ext(warm.v),
                        w=jnp.zeros((n + 2,) * 3, jnp.float64),
                        p=ext(warm.p))

    want = tv.simulate(cfg, warm, 1, istep0=istep2)
    got = simulate_3d(g3, state3, 1, pressure_solver="rbsor",
                      sor_tol=1e-6, sor_max_iter=100_000, csf=True,
                      istep0=istep3)

    # w stays (essentially) zero and the state stays z-invariant
    assert float(jnp.max(jnp.abs(got.w))) < 1e-9
    mid = n // 2
    for name in ("F", "u", "v"):
        a3 = np.asarray(getattr(got, name))
        assert np.max(np.abs(a3 - a3[:, :, mid:mid + 1])[1:-1, 1:-1, 1:-1]
                      ) < 1e-9, f"{name} not z-invariant"
        np.testing.assert_allclose(
            a3[1:-1, 1:-1, mid], np.asarray(getattr(want, name))[1:-1, 1:-1],
            atol=1e-10, err_msg=name)
    # p: gradient-only comparison (free constant differs per solver)
    p3 = np.asarray(got.p)[1:-1, 1:-1, mid]
    p2 = np.asarray(want.p)[1:-1, 1:-1]
    np.testing.assert_allclose(np.diff(p3, axis=0), np.diff(p2, axis=0),
                               atol=1e-7)
    np.testing.assert_allclose(np.diff(p3, axis=1), np.diff(p2, axis=1),
                               atol=1e-7)


def test_cli_rejects_csf_outside_3d(capsys):
    from tpuvof.cli import main

    assert main(["--csf", "--nx", "16", "--steps", "1",
                 "--no-frames"]) == 2
    assert "--three-d" in capsys.readouterr().err
