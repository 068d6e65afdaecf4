"""Shared helpers for the stencil ops.

Every op in this package is a pure function from arrays to arrays: the
reference's in-place Taichi kernels (per-cell `ti.ndrange` loops) become
whole-array shifted-slice expressions that XLA fuses into a handful of HBM
passes. Loop bounds like `ti.ndrange((imin+1, imax+1), (jmin, jmax+1))`
translate to window slices via :func:`win`.
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = ["win", "win3", "clamp01", "median3", "interior", "set_interior",
           "embed2", "embed3"]


def win(a, ri, rj, di: int = 0, dj: int = 0):
    """Slice array ``a`` over the index window ``ri x rj`` shifted by (di, dj).

    ``ri = (i0, i1)`` covers reference indices i in [i0, i1) — the direct
    translation of ``ti.ndrange((i0, i1), (j0, j1))`` with a stencil offset.
    """
    (i0, i1) = ri
    (j0, j1) = rj
    return a[i0 + di : i1 + di, j0 + dj : j1 + dj]


def win3(a, ri, rj, rk, di: int = 0, dj: int = 0, dk: int = 0):
    (i0, i1) = ri
    (j0, j1) = rj
    (k0, k1) = rk
    return a[i0 + di : i1 + di, j0 + dj : j1 + dj, k0 + dk : k1 + dk]


def clamp01(x):
    """median(0, 1, x) == clip to [0, 1] (reference `var`, 2dvof.py:192-195).

    Implemented with strict-comparison selects rather than jnp.clip: the
    values are identical, but the VJP differs at the boundaries. jnp.clip's
    max/min give derivative 0.5 at exact ties, which under autodiff halves
    the gradient at every per-step clamp — through T steps that is a 0.5^T
    attenuation that freezes the F0 optimization whenever F sits exactly at
    0 or 1 (its starting state!). Taichi's median-of-selects passes
    derivative 1 at the boundary (diff_vof.py differentiates *through* the
    clamps, SURVEY.md §7 step 3); this form reproduces that.
    """
    return jnp.where(x < 0.0, 0.0, jnp.where(x > 1.0, 1.0, x))


def median3(a, b, c):
    """Median of three, exactly as the reference computes it."""
    return a + b + c - jnp.maximum(a, jnp.maximum(b, c)) - jnp.minimum(
        a, jnp.minimum(b, c)
    )


def interior(a):
    """The non-ghost region of a field array (any rank)."""
    return a[tuple(slice(1, -1) for _ in range(a.ndim))]


def embed2(x, lo0: int, hi0: int, lo1: int, hi1: int):
    """Embed a 2-D block into a larger array padded with zeros: lo/hi give
    the number of zero rows/cols added on each side.

    Implemented with concatenation instead of ``.at[...].set``; XLA
    produces identical values either way.
    """
    d = x.dtype
    if lo0 or hi0:
        parts = []
        if lo0:
            parts.append(jnp.zeros((lo0, x.shape[1]), d))
        parts.append(x)
        if hi0:
            parts.append(jnp.zeros((hi0, x.shape[1]), d))
        x = jnp.concatenate(parts, axis=0)
    if lo1 or hi1:
        parts = []
        if lo1:
            parts.append(jnp.zeros((x.shape[0], lo1), d))
        parts.append(x)
        if hi1:
            parts.append(jnp.zeros((x.shape[0], hi1), d))
        x = jnp.concatenate(parts, axis=1)
    return x


def embed3(x, lo0: int, hi0: int, lo1: int, hi1: int, lo2: int, hi2: int):
    """3-D :func:`embed2`: zero-pad ``x`` by (lo, hi) cells along each axis.

    Same concatenation form as embed2."""
    d = x.dtype
    for ax, (lo, hi) in enumerate(((lo0, hi0), (lo1, hi1), (lo2, hi2))):
        if not (lo or hi):
            continue
        parts = []
        if lo:
            shape = x.shape[:ax] + (lo,) + x.shape[ax + 1:]
            parts.append(jnp.zeros(shape, d))
        parts.append(x)
        if hi:
            shape = x.shape[:ax] + (hi,) + x.shape[ax + 1:]
            parts.append(jnp.zeros(shape, d))
        x = jnp.concatenate(parts, axis=ax)
    return x


def merge_interior(full, interior_val):
    """Replace the interior of ``full`` with ``interior_val`` (ghosts kept),
    without partial-update primitives."""
    import jax

    n0, n1 = full.shape
    row = jax.lax.broadcasted_iota(jnp.int32, (n0, n1), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (n0, n1), 1)
    mask = (row >= 1) & (row <= n0 - 2) & (col >= 1) & (col <= n1 - 2)
    return jnp.where(mask, embed2(interior_val, 1, 1, 1, 1), full)


def merge_region(full, val, r0: int, r1: int, c0: int, c1: int):
    """Replace full[r0:r1, c0:c1] with ``val`` without a scatter."""
    import jax

    n0, n1 = full.shape
    row = jax.lax.broadcasted_iota(jnp.int32, (n0, n1), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (n0, n1), 1)
    mask = (row >= r0) & (row < r1) & (col >= c0) & (col < c1)
    return jnp.where(mask, embed2(val, r0, n0 - r1, c0, n1 - c1), full)


def set_interior(a, values):
    """Return a copy of ``a`` with its interior replaced."""
    return a.at[tuple(slice(1, -1) for _ in range(a.ndim))].set(values)
