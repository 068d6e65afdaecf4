"""Rudman/Zalesak flux-corrected transport (FCT) VOF advection — 2-D.

Re-derivation of the reference's four-pass sweeps (fct_x_sweep 2dvof.py:321-382,
fct_y_sweep :385-448) in face-flux form. The reference's cell loops write the
same face quantity twice (ax[i+1,j] from iteration i and ax[i,j] from
iteration i+1 produce identical values, since the right flux of cell i *is*
the left flux of cell i+1); the face-based formulation computes each face
once, which is both the natural vectorization and the honest data layout.

The four passes per sweep:
  1. donor-cell (low-order) transported/diffused value Ftd with the
     divergence compensation dV/dv,
  2. anti-diffusive face flux a = f_H - f_L (high-order = downwind donor)
     and the Zalesak limiter ratios rp/rm against local extrema of Ftd,
  3. corrected flux factor c per face, selected by flux sign,
  4. apply the limited anti-diffusion.

Ghost-cell conventions are load-bearing and replicated exactly: Ftd/rp/rm/a/c
ghost entries are zero (the reference never writes them and they are
zero-initialized fields), while F's ghosts persist from the last boundary
application (the main solver does NOT refresh them between half-sweeps).

With square cells (dx == dy, enforced by Grid2D.validate) the reference's
y-sweep is the exact transpose of its x-sweep — including the quirk that the
limiter numerators are scaled by dx in both sweeps (2dvof.py:417,423) — so a
single axis-0 kernel serves both directions via transposition.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import FCTVariant, Numerics
from .bc import mirror_scalar
from .common import clamp01, embed2, merge_interior
from ..grid import Grid2D

__all__ = ["fct_sweep_x", "fct_sweep_y", "rudman_advect"]


def _max3(a, b, c):
    return jnp.maximum(a, jnp.maximum(b, c))


def _min3(a, b, c):
    return jnp.minimum(a, jnp.minimum(b, c))


def _sweep_axis0(dx: float, dy: float, dt: float, var: FCTVariant, F, u, sync=None):
    """One FCT sweep along axis 0 of (n0+2, n1+2) arrays.

    ``u`` is the face-normal velocity: u[i, j] lives on the lower axis-0 face
    of cell (i, j). Returns the updated F (ghosts preserved).

    ``sync`` (distributed mode) refreshes the ghost ring of an intermediate
    from mesh neighbors; serial mode leaves the reference's zero ghosts.
    """
    # ---- face fluxes on faces f in [1, n0+1], j in [1, n1] ----
    uf = u[1:, 1:-1]
    F_up = F[:-1, 1:-1]  # donor cell below the face
    F_dn = F[1:, 1:-1]  # donor cell above the face
    fL = uf * dt * jnp.where(uf >= 0, F_up, F_dn)  # upwind (low order)
    fH = uf * dt * jnp.where(uf <= 0, F_up, F_dn)  # downwind (high order)
    a_int = fH - fL  # anti-diffusive face flux
    a = embed2(a_int, 1, 0, 1, 1)

    # ---- pass 1: low-order transported & diffused value ----
    F_c = F[1:-1, 1:-1]
    du = uf[1:] - uf[:-1]  # u[i+1,j] - u[i,j] over interior cells
    dv = dx * dy - dt * dy * du
    netflux = (fL[:-1] - fL[1:]) * dy / (dx * dy)
    if var.full_dv:
        ftd_int = (F_c + netflux) * dx * dy / dv
    else:
        ftd_int = F_c + netflux * dx * dy / dv
    if var.clamp:
        ftd_int = clamp01(ftd_int)
    Ftd = embed2(ftd_int, 1, 1, 1, 1)
    if sync is not None:
        Ftd = sync(Ftd)
        ftd_int = Ftd[1:-1, 1:-1]

    # ---- pass 2: Zalesak limiter ratios (reads Ftd's zero ghosts at the
    # domain edge, exactly like the reference) ----
    fmax = _max3(Ftd[1:-1, 1:-1], Ftd[:-2, 1:-1], Ftd[2:, 1:-1])
    fmin = _min3(Ftd[1:-1, 1:-1], Ftd[:-2, 1:-1], Ftd[2:, 1:-1])
    a_lo = a[1:-1, 1:-1]  # flux through the cell's lower face
    a_hi = a[2:, 1:-1]  # flux through the cell's upper face

    pp = jnp.maximum(0.0, a_lo) - jnp.minimum(0.0, a_hi)
    qp = (fmax - ftd_int) * dx
    den_p = jnp.where(pp > var.guard_eps, pp + var.denom_eps, 1.0)
    rp_int = jnp.where(pp > var.guard_eps, jnp.minimum(1.0, qp / den_p), 0.0)

    pm = jnp.maximum(0.0, a_hi) - jnp.minimum(0.0, a_lo)
    qm = (ftd_int - fmin) * dx
    den_m = jnp.where(pm > var.guard_eps, pm + var.denom_eps, 1.0)
    rm_int = jnp.where(pm > var.guard_eps, jnp.minimum(1.0, qm / den_m), 0.0)

    rp = embed2(rp_int, 1, 1, 1, 1)
    rm = embed2(rm_int, 1, 1, 1, 1)
    if sync is not None:
        rp = sync(rp)
        rm = sync(rm)

    # ---- pass 3: corrected flux factor per face: c[f] = min(rp[f], rm[f-1])
    # or min(rp[f-1], rm[f]) by flux sign. Computed on all faces [1, n0+1];
    # the reference leaves the wall face at its zero-initialized c
    # (2dvof.py:365-374 writes only cx[i+1]), but that face's a is exactly 0
    # there (u=0 wall BC), so a*c is identical — and in the distributed case
    # face 1 of a non-edge shard is a live interior face needing the real
    # value from the neighbor's rp/rm (in its ghost ring).
    a_f = a[1:, 1:-1]
    rp_pad = rp[:-1, 1:-1]  # rp at cell f-1 (zero ghost below the wall)
    rm_pad = rm[:-1, 1:-1]
    c_int = jnp.where(
        a_f >= 0,
        jnp.minimum(rp[1:, 1:-1], rm_pad),
        jnp.minimum(rp_pad, rm[1:, 1:-1]),
    )
    c = embed2(c_int, 1, 0, 1, 1)

    # ---- pass 4: apply limited anti-diffusion ----
    corr = (a[2:, 1:-1] * c[2:, 1:-1] - a[1:-1, 1:-1] * c[1:-1, 1:-1]) / dy
    f_new = ftd_int - corr * dx * dy / dv
    if var.clamp:
        f_new = clamp01(f_new)
    return merge_interior(F, f_new)


def fct_sweep_x(g: Grid2D, nm: Numerics, F, u, var: FCTVariant | None = None, sync=None):
    var = nm.fct if var is None else var
    with jax.named_scope("fct_x"):
        return _sweep_axis0(g.dx, g.dy, nm.dt, var, F, u, sync=sync)


def fct_sweep_y(g: Grid2D, nm: Numerics, F, v, var: FCTVariant | None = None, sync=None):
    var = nm.fct if var is None else var
    # Square cells make the y-sweep the exact transpose of the x-sweep,
    # including the reference's dx-scaled limiter numerators (2dvof.py:417).
    sync_t = None if sync is None else (lambda a: sync(a.T).T)
    with jax.named_scope("fct_y"):
        return _sweep_axis0(g.dy, g.dx, nm.dt, var, F.T, v.T,
                            sync=sync_t).T




def rudman_advect(
    g: Grid2D,
    nm: Numerics,
    F,
    u,
    v,
    even_step: bool,
    var: FCTVariant | None = None,
):
    """Strang-alternated double sweep (reference solve_VOF_rudman,
    2dvof.py:312-318): even steps sweep y then x, odd steps x then y.
    ``even_step`` must be a Python bool (compile-time schedule)."""
    var = nm.fct if var is None else var
    if even_step:
        F = fct_sweep_y(g, nm, F, v, var)
        if nm.bc_between_sweeps:
            F = mirror_scalar(F)
        F = fct_sweep_x(g, nm, F, u, var)
    else:
        F = fct_sweep_x(g, nm, F, u, var)
        if nm.bc_between_sweeps:
            F = mirror_scalar(F)
        F = fct_sweep_y(g, nm, F, v, var)
    if nm.bc_between_sweeps:
        F = mirror_scalar(F)
    return F
