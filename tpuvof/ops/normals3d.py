"""Youngs interface normals and Brackbill curvature in 3-D (opt-in CSF).

The reference DISABLES 3-D surface tension: its 3-D normals kernel exists
only as commented-out code (3dvof.py:304-332) and kappa is never written
(3dvof.py:607), so the CSF terms in the 3-D momentum predictor are inert.
This module completes the capability as the straight 3-D extension of the
2-D op (ops/normals.py, reference 2dvof.py:283-309): the cell normal is
the average of F-gradients evaluated at the EIGHT cell corners, each
corner gradient averaging the four face-pair differences that straddle
the corner; kappa = -div(m-hat) by central differences.

Off by default (`simulate_3d(..., csf=False)` matches the reference's
inert-kappa behavior bit-for-bit); enabling it is the documented upgrade.
Conventions mirror the 2-D op exactly: full-shape outputs with zero
ghosts, and the 1e-10 degeneracy guard keeps raw components (NaN-safe
`where`, so grad never sees 0/0).

The corner-gradient form is kept literal (not algebraically collapsed to
central differences of a smoothed F): FP reassociation flips cells across
the 1e-10 guard and perturbs the interface — and the extrusion
parity test (tests/test_csf3d.py) pins this form against the 2-D op.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..grid import Grid3D
from .common import win3, embed3

__all__ = ["young_msum_3d", "normalize_normals_3d", "young_normals_3d",
           "curvature_from_normals_3d", "young_normals_curvature_3d"]


def young_msum_3d(f, dx, dy, dz):
    """Raw (unnormalized) Youngs normal sums (mxs, mys, mzs) from an
    F-window accessor ``f(di, dj, dk)`` (the XLA op passes a win3
    accessor), so the accumulation order is fixed in one place."""

    def corner_grad(axis, sx, sy, sz):
        """F-gradient along `axis` at the cell corner selected by the sign
        triple (sx, sy, sz): the mean of the four face-pair differences
        straddling that corner (2-D analog: 2dvof.py:287-294)."""
        signs = (sx, sy, sz)
        lo = 0 if signs[axis] > 0 else -1
        others = [ax for ax in range(3) if ax != axis]
        acc = None
        for da in (0, signs[others[0]]):
            for db in (0, signs[others[1]]):
                off_hi = [0, 0, 0]
                off_hi[axis] = lo + 1
                off_hi[others[0]] = da
                off_hi[others[1]] = db
                off_lo = list(off_hi)
                off_lo[axis] = lo
                d = f(*off_hi) - f(*off_lo)
                acc = d if acc is None else acc + d
        h = (dx, dy, dz)[axis]
        return -acc / (4.0 * h)

    corners = [(sx, sy, sz) for sx in (1, -1) for sy in (1, -1)
               for sz in (1, -1)]
    msum = []
    for axis in range(3):
        acc = None
        for c in corners:
            gax = corner_grad(axis, *c)
            acc = gax if acc is None else acc + gax
        msum.append(acc / 8.0)
    return tuple(msum)


def normalize_normals_3d(mxs, mys, mzs):
    """Unit normals with the 1e-10 degeneracy guard (NaN-safe `where`,
    keeps raw components on degenerate cells; shared by op and kernel)."""
    degenerate = ((jnp.abs(mxs) < 1e-10) & (jnp.abs(mys) < 1e-10)
                  & (jnp.abs(mzs) < 1e-10))
    mag_sq = mxs * mxs + mys * mys + mzs * mzs
    safe_mag = jnp.sqrt(jnp.where(degenerate, 1.0, mag_sq))
    mx = jnp.where(degenerate, mxs, mxs / safe_mag)
    my = jnp.where(degenerate, mys, mys / safe_mag)
    mz = jnp.where(degenerate, mzs, mzs / safe_mag)
    return mx, my, mz


def young_normals_3d(g: Grid3D, F):
    """Normalized Youngs normals (mx, my, mz), full-shape, zero ghosts."""
    ri = (1, g.nx + 1)
    rj = (1, g.ny + 1)
    rk = (1, g.nz + 1)

    def f(di, dj, dk):
        return win3(F, ri, rj, rk, di, dj, dk)

    mxs, mys, mzs = young_msum_3d(f, g.dx, g.dy, g.dz)
    mx, my, mz = normalize_normals_3d(mxs, mys, mzs)
    return (embed3(mx, 1, 1, 1, 1, 1, 1), embed3(my, 1, 1, 1, 1, 1, 1),
            embed3(mz, 1, 1, 1, 1, 1, 1))


def curvature_from_normals_3d(g: Grid3D, mx, my, mz):
    """kappa = -div(m-hat) by central differences; reads the ghost-zero
    normals at the domain edge exactly like the 2-D op."""
    ri = (1, g.nx + 1)
    rj = (1, g.ny + 1)
    rk = (1, g.nz + 1)
    kap = -(
        (win3(mx, ri, rj, rk, 1, 0, 0) - win3(mx, ri, rj, rk, -1, 0, 0))
        / (2.0 * g.dx)
        + (win3(my, ri, rj, rk, 0, 1, 0) - win3(my, ri, rj, rk, 0, -1, 0))
        / (2.0 * g.dy)
        + (win3(mz, ri, rj, rk, 0, 0, 1) - win3(mz, ri, rj, rk, 0, 0, -1))
        / (2.0 * g.dz)
    )
    return embed3(kap, 1, 1, 1, 1, 1, 1)


def young_normals_curvature_3d(g: Grid3D, F):
    """(mx, my, mz, kappa), all full-shape with zero ghosts."""
    mx, my, mz = young_normals_3d(g, F)
    return mx, my, mz, curvature_from_normals_3d(g, mx, my, mz)
