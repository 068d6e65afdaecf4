"""3-D Rudman FCT sweeps (reference 3dvof.py:366-541).

One generic sweep along axis 0 of (n0+2, n1+2, n2+2) arrays, parameterized
by the literal scale factors of the reference's three sweeps — which are NOT
uniform: the y-sweep keeps a 2-D flux scale dy/(dx*dy) (3dvof.py:438,
SURVEY.md §2.5.5) and the limiter numerators use dx for x/y sweeps but dz
for z (3dvof.py:398,462,519). On the uniform cubic cells the reference
always uses, these coincide numerically, but the factors are kept explicit
so the implementation is honest to the source. The x/y/z sweeps are
transposes of the axis-0 kernel.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..grid import Grid3D
from .common import clamp01

__all__ = ["fct3d_sweep_x", "fct3d_sweep_y", "fct3d_sweep_z",
           "fct3d_sweep_x_windowed", "sweep_masked_2axis",
           "rudman_advect_3d"]


def _sweep3d_axis0(vol, dv_area, flux_scale, q_scale, final_div, dt, F, u):
    """FCT sweep along axis 0; u is the face-normal velocity on the lower
    axis-0 faces. All clamping active (3dvof clamps like 2dvof).

    vol: cell volume; dv_area: face area multiplying dt*du in dv;
    flux_scale: factor applied to the net donor flux; q_scale: limiter
    numerator scale; final_div: divisor in the antidiffusion application.
    """
    uf = u[1:, 1:-1, 1:-1]
    F_up = F[:-1, 1:-1, 1:-1]
    F_dn = F[1:, 1:-1, 1:-1]
    fL = uf * dt * jnp.where(uf >= 0, F_up, F_dn)
    fH = uf * dt * jnp.where(uf <= 0, F_up, F_dn)
    a = jnp.zeros_like(F).at[1:, 1:-1, 1:-1].set(fH - fL)

    F_c = F[1:-1, 1:-1, 1:-1]
    dv = vol - dt * dv_area * (uf[1:] - uf[:-1])
    ftd_int = (F_c + (fL[:-1] - fL[1:]) * flux_scale) * vol / dv
    ftd_int = clamp01(ftd_int)
    Ftd = jnp.zeros_like(F).at[1:-1, 1:-1, 1:-1].set(ftd_int)

    fmax = jnp.maximum(Ftd[1:-1, 1:-1, 1:-1],
                       jnp.maximum(Ftd[:-2, 1:-1, 1:-1], Ftd[2:, 1:-1, 1:-1]))
    fmin = jnp.minimum(Ftd[1:-1, 1:-1, 1:-1],
                       jnp.minimum(Ftd[:-2, 1:-1, 1:-1], Ftd[2:, 1:-1, 1:-1]))
    a_lo = a[1:-1, 1:-1, 1:-1]
    a_hi = a[2:, 1:-1, 1:-1]

    pp = jnp.maximum(0.0, a_lo) - jnp.minimum(0.0, a_hi)
    qp = (fmax - ftd_int) * q_scale
    rp_int = jnp.where(pp > 0, jnp.minimum(1.0, qp / jnp.where(pp > 0, pp, 1.0)), 0.0)
    pm = jnp.maximum(0.0, a_hi) - jnp.minimum(0.0, a_lo)
    qm = (ftd_int - fmin) * q_scale
    rm_int = jnp.where(pm > 0, jnp.minimum(1.0, qm / jnp.where(pm > 0, pm, 1.0)), 0.0)

    rp = jnp.zeros_like(F).at[1:-1, 1:-1, 1:-1].set(rp_int)
    rm = jnp.zeros_like(F).at[1:-1, 1:-1, 1:-1].set(rm_int)

    a_f = a[1:, 1:-1, 1:-1]
    c_int = jnp.where(
        a_f >= 0,
        jnp.minimum(rp[1:, 1:-1, 1:-1], rm[:-1, 1:-1, 1:-1]),
        jnp.minimum(rp[:-1, 1:-1, 1:-1], rm[1:, 1:-1, 1:-1]),
    )
    c = jnp.zeros_like(F).at[1:, 1:-1, 1:-1].set(c_int)

    corr = (a[2:, 1:-1, 1:-1] * c[2:, 1:-1, 1:-1]
            - a[1:-1, 1:-1, 1:-1] * c[1:-1, 1:-1, 1:-1]) / final_div
    f_new = clamp01(ftd_int - corr * vol / dv)
    return F.at[1:-1, 1:-1, 1:-1].set(f_new)


def fct3d_sweep_x(g: Grid3D, dt, F, u):
    vol = g.dx * g.dy * g.dz
    return _sweep3d_axis0(
        vol, g.dy * g.dz, g.dy * g.dz / vol, g.dx, g.dy, dt, F, u
    )


def fct3d_sweep_y(g: Grid3D, dt, F, v):
    vol = g.dx * g.dy * g.dz
    Ft = jnp.transpose(F, (1, 0, 2))
    vt = jnp.transpose(v, (1, 0, 2))
    # 2-D flux scale dy/(dx*dy) kept from the reference (3dvof.py:438)
    out = _sweep3d_axis0(
        vol, g.dx * g.dz, g.dy / (g.dx * g.dy), g.dx, g.dy, dt, Ft, vt
    )
    return jnp.transpose(out, (1, 0, 2))


def fct3d_sweep_z(g: Grid3D, dt, F, w):
    vol = g.dx * g.dy * g.dz
    Ft = jnp.transpose(F, (2, 0, 1))
    wt = jnp.transpose(w, (2, 0, 1))
    out = _sweep3d_axis0(
        vol, g.dx * g.dy, g.dy * g.dx / vol, g.dz, g.dz, dt, Ft, wt
    )
    return jnp.transpose(out, (1, 2, 0))


def _axis_scales(g: Grid3D, axis: int):
    """The reference's literal (non-uniform) scale factors per sweep axis
    — (vol, dv_area, flux_scale, q_scale, final_div); 3dvof.py:438 keeps
    the 2-D dy/(dx*dy) flux scale in the y-sweep."""
    vol = g.dx * g.dy * g.dz
    if axis == 0:
        return (vol, g.dy * g.dz, g.dy * g.dz / vol, g.dx, g.dy)
    if axis == 1:
        return (vol, g.dx * g.dz, g.dy / (g.dx * g.dy), g.dx, g.dy)
    return (vol, g.dx * g.dy, g.dy * g.dx / vol, g.dz, g.dz)


def _sh3(x, di=0, dj=0, dk=0):
    """x[i+di, j+dj, k+dk] with wrap-around; callers mask the junk."""
    if di:
        x = jnp.roll(x, -di, axis=0)
    if dj:
        x = jnp.roll(x, -dj, axis=1)
    if dk:
        x = jnp.roll(x, -dk, axis=2)
    return x


def sweep_x_masked(g: Grid3D, dt, F, vel, gi0):
    """One x-direction Rudman/Zalesak sweep (3dvof.py:366-541) in the
    roll+mask form of the windowed distributed sweep: plane l
    of the block holds global i-index gi0 + l (traced or static), all
    masks are global, and positions within 3 planes of a block edge are
    junk unless the edge is the true array edge. Non-interior positions
    carry the input F through. THE single source of the x-limiter chain in
    masked form (the serial XLA sweeps use the equivalent transpose/axis0
    statement of the same formulas, _sweep3d_axis0)."""
    import jax

    vol, dv_area, flux_scale, q_scale, final_div = _axis_scales(g, 0)
    shape = F.shape
    gi = jax.lax.broadcasted_iota(jnp.int32, shape, 0) + gi0
    j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    k = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    o_int = (j >= 1) & (j <= g.ny) & (k >= 1) & (k <= g.nz)

    F_up = _sh3(F, -1, 0, 0)
    fL = vel * dt * jnp.where(vel >= 0, F_up, F)
    fH = vel * dt * jnp.where(vel <= 0, F_up, F)
    a = jnp.where((gi >= 1) & o_int, fH - fL, 0.0)
    dv = vol - dt * dv_area * (_sh3(vel, 1, 0, 0) - vel)
    ftd = clamp01((F + (fL - _sh3(fL, 1, 0, 0)) * flux_scale) * vol / dv)
    int_m = (gi >= 1) & (gi <= g.nx) & o_int
    Ftd = jnp.where(int_m, ftd, 0.0)
    fmax = jnp.maximum(Ftd, jnp.maximum(_sh3(Ftd, -1, 0, 0),
                                        _sh3(Ftd, 1, 0, 0)))
    fmin = jnp.minimum(Ftd, jnp.minimum(_sh3(Ftd, -1, 0, 0),
                                        _sh3(Ftd, 1, 0, 0)))
    a_hi = _sh3(a, 1, 0, 0)
    pp = jnp.maximum(0.0, a) - jnp.minimum(0.0, a_hi)
    qp = (fmax - Ftd) * q_scale
    rp = jnp.where(int_m & (pp > 0),
                   jnp.minimum(1.0, qp / jnp.where(pp > 0, pp, 1.0)), 0.0)
    pm = jnp.maximum(0.0, a_hi) - jnp.minimum(0.0, a)
    qm = (Ftd - fmin) * q_scale
    rm = jnp.where(int_m & (pm > 0),
                   jnp.minimum(1.0, qm / jnp.where(pm > 0, pm, 1.0)), 0.0)
    cfct = jnp.where(
        (gi >= 1) & o_int,
        jnp.where(a >= 0,
                  jnp.minimum(rp, _sh3(rm, -1, 0, 0)),
                  jnp.minimum(_sh3(rp, -1, 0, 0), rm)),
        0.0,
    )
    corr = (_sh3(a, 1, 0, 0) * _sh3(cfct, 1, 0, 0) - a * cfct) / final_div
    return jnp.where(int_m, clamp01(Ftd - corr * vol / dv), F)


def sweep_masked_2axis(g: Grid3D, dt, F, vel, axis: int, gi0, gj0):
    """One Rudman/Zalesak sweep along ``axis`` (0=x, 1=y, 2=z) in
    roll+mask form with GLOBAL index masks on BOTH the i and j axes —
    the sweep kernel of the two-axis (x,y)-decomposed solver
    (parallel/dist3d.py with py > 1). Local
    position (l, m, n) holds global indices (gi0 + l, gj0 + m, n); k (z)
    is never decomposed. Positions within 3 cells of a block edge along
    the sweep axis are junk unless that edge is the true wall;
    non-interior positions carry the input F through. Same limiter chain
    as sweep_x_masked (3dvof.py:366-541) —
    cross-pinned against the serial sweeps in tests/test_parallel_3d.py."""
    import jax

    vol, dv_area, flux_scale, q_scale, final_div = _axis_scales(g, axis)
    shape = F.shape
    gi = jax.lax.broadcasted_iota(jnp.int32, shape, 0) + gi0
    gj = jax.lax.broadcasted_iota(jnp.int32, shape, 1) + gj0
    k = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    m_i = (gi >= 1) & (gi <= g.nx)
    m_j = (gj >= 1) & (gj <= g.ny)
    m_k = (k >= 1) & (k <= g.nz)
    sw = (gi, gj, k)[axis]
    n_sweep = (g.nx, g.ny, g.nz)[axis]
    o_int = {0: m_j & m_k, 1: m_i & m_k, 2: m_i & m_j}[axis]

    def sh(x, d):
        return _sh3(x, d if axis == 0 else 0, d if axis == 1 else 0,
                    d if axis == 2 else 0)

    F_up = sh(F, -1)
    fL = vel * dt * jnp.where(vel >= 0, F_up, F)
    fH = vel * dt * jnp.where(vel <= 0, F_up, F)
    a = jnp.where((sw >= 1) & o_int, fH - fL, 0.0)
    dv = vol - dt * dv_area * (sh(vel, 1) - vel)
    ftd = clamp01((F + (fL - sh(fL, 1)) * flux_scale) * vol / dv)
    int_m = (sw >= 1) & (sw <= n_sweep) & o_int
    Ftd = jnp.where(int_m, ftd, 0.0)
    fmax = jnp.maximum(Ftd, jnp.maximum(sh(Ftd, -1), sh(Ftd, 1)))
    fmin = jnp.minimum(Ftd, jnp.minimum(sh(Ftd, -1), sh(Ftd, 1)))
    a_hi = sh(a, 1)
    pp = jnp.maximum(0.0, a) - jnp.minimum(0.0, a_hi)
    qp = (fmax - Ftd) * q_scale
    rp = jnp.where(int_m & (pp > 0),
                   jnp.minimum(1.0, qp / jnp.where(pp > 0, pp, 1.0)), 0.0)
    pm = jnp.maximum(0.0, a_hi) - jnp.minimum(0.0, a)
    qm = (Ftd - fmin) * q_scale
    rm = jnp.where(int_m & (pm > 0),
                   jnp.minimum(1.0, qm / jnp.where(pm > 0, pm, 1.0)), 0.0)
    cfct = jnp.where(
        (sw >= 1) & o_int,
        jnp.where(a >= 0,
                  jnp.minimum(rp, sh(rm, -1)),
                  jnp.minimum(sh(rp, -1), rm)),
        0.0,
    )
    corr = (sh(a, 1) * sh(cfct, 1) - a * cfct) / final_div
    return jnp.where(int_m, clamp01(Ftd - corr * vol / dv), F)


def fct3d_sweep_x_windowed(g: Grid3D, dt, F_ext, u_ext, gi0):
    """The x-sweep on an i-extended block, for the x-decomposed solver
    (parallel/dist3d.py): ``F_ext``/``u_ext`` carry the shard's planes plus
    a 3-plane dependency halo; plane l holds global i-index ``gi0 + l``.
    Thin alias of sweep_x_masked (the shared masked limiter body)."""
    return sweep_x_masked(g, dt, F_ext, u_ext, gi0)


def rudman_advect_3d(g: Grid3D, dt, F, u, v, w, phase: int):
    """Three-way sweep rotation by istep % 3 (3dvof.py:351-363); each
    sweep runs under its own `jax.named_scope` (fct_x/fct_y/fct_z)."""
    sweeps = {0: (fct3d_sweep_x, u), 1: (fct3d_sweep_y, v),
              2: (fct3d_sweep_z, w)}
    for ax in ((0, 1, 2), (1, 2, 0), (2, 0, 1))[phase]:
        fn, vel = sweeps[ax]
        with jax.named_scope("fct_" + "xyz"[ax]):
            F = fn(g, dt, F, vel)
    return F


def upwind_advect_3d(g: Grid3D, dt, F, u, v, w):
    """Plain donor-cell VOF update (reference solve_VOF_upwind,
    3dvof.py:335-347 — present but disabled in its main loop :620).
    Kept for capability parity; note the reference's own 2-D volume factor
    dx*dy/(dx*dy*dz) in the update (:347)."""
    Ftd = F

    def face_flux(vel, lo, hi):
        return vel * dt * jnp.where(vel > 0, lo, hi)

    c = Ftd[1:-1, 1:-1, 1:-1]
    fl = face_flux(u[1:-1, 1:-1, 1:-1], Ftd[:-2, 1:-1, 1:-1], c)
    fr = face_flux(u[2:, 1:-1, 1:-1], c, Ftd[2:, 1:-1, 1:-1])
    fs = face_flux(v[1:-1, 1:-1, 1:-1], Ftd[1:-1, :-2, 1:-1], c)
    fn = face_flux(v[1:-1, 2:, 1:-1], c, Ftd[1:-1, 2:, 1:-1])
    fb = face_flux(w[1:-1, 1:-1, 1:-1], Ftd[1:-1, 1:-1, :-2], c)
    ff = face_flux(w[1:-1, 1:-1, 2:], c, Ftd[1:-1, 1:-1, 2:])
    upd = c + (fl - fr + fs - fn + fb - ff) * (g.dx * g.dy) / (g.dx * g.dy * g.dz)
    return F.at[1:-1, 1:-1, 1:-1].set(upd)
