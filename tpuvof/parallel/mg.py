"""Distributed geometric multigrid for the sharded pressure solve.

The scale-out form of ops/mg.py (the production pressure upgrade: mg at
sor_tol_rel=1e-2 takes a few V-cycles per step where rbsor runs to its
iteration cap). The reference has
no counterpart at any scale (its 3-D solver hardcodes fixed Jacobi sweeps,
reference 3dvof.py:334-349); this module exists so `Decomp`/`Decomp3D`
users get the same solver ladder as serial runs instead of being pinned to
the rbsor fallback.

Decomposition of a V-cycle (the scaling-book recipe: fine levels ride
compute, coarse levels ride a collective):

  - FINE levels run sharded: red-black smoothing with one ppermute halo
    exchange per half-sweep, block-mean restriction purely shard-local,
    prolongation with a one-cell neighbor slice exchange. All per-cell
    arithmetic mirrors ops/mg.py exactly (same coefficient construction
    from GLOBAL indices, same operation order), so the distributed solve
    matches serial to collective-reassociation noise (pinned at 1e-12 f64
    by tests/test_mg_dist.py).
  - COARSE levels are gathered: below a crossover (global volume <=
    ``gather_volume``, or where the mesh no longer divides the level) the
    restricted problem is all-gathered and the remaining sub-ladder runs
    REPLICATED through the serial vcycle (ops.mg._make_vcycle) — identical
    on every shard, so no further communication until the error is sliced
    back. A latency-bound 4^2-cell coarse solve costs one all_gather
    instead of 2*coarse_iters exchanges.

The outer residual-driven loop matches ops.mg.mg_solve (same stall/plateau
exits); residual/scale reductions are global psum/pmax so every shard takes
the identical trip count — including the sor_tol_rel relative stop.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.mg import (_build_levels, _make_vcycle, _nu_policy, _prolong,
                      _restrict, mg_levels)
from ..ops.poisson import PLATEAU_FACTOR, STALL_ITERS  # noqa: F401 (doc tie)

__all__ = ["MGDecomp", "mg_solve_dist"]


@dataclass(frozen=True)
class MGDecomp:
    """Static shard layout for the distributed solve: per ARRAY axis, the
    mesh axis name and shard count (1 = unsharded). A name with one shard
    is a size-1 mesh axis: nothing is exchanged along it, but the global
    reductions run over it so their scalars stay mesh-invariant (the
    while_loop carries must). None = no mesh axis."""

    axis_names: tuple
    shards: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.shards):
            raise ValueError("axis_names and shards must align per axis")
        for name, n in zip(self.axis_names, self.shards):
            if n > 1 and name is None:
                raise ValueError(
                    f"sharded axes need a mesh axis name (got {name!r} "
                    f"with {n} shards)")

    def idx(self, ax):
        """Traced shard index along array axis ``ax`` (0 when unsharded)."""
        return (lax.axis_index(self.axis_names[ax])
                if self.shards[ax] > 1 else 0)


def _shift(sl, axis_name: str, n: int, up: bool):
    """One-hop neighbor transfer (cf. parallel.halo._shift)."""
    perm = ([(i, i + 1) for i in range(n - 1)] if up
            else [(i + 1, i) for i in range(n - 1)])
    return lax.ppermute(sl, axis_name, perm)


def _exchange_nd(spec: MGDecomp, a):
    """Refresh the one-cell ghost shell of a ghosted local block along
    every sharded axis (edge shards keep their existing ghosts — here
    always zeros, inert under the edge-zeroed operator coefficients).
    Staged in axis order so corner ghosts land via two hops; the 5/7-point
    smoother only reads face neighbors, but staging costs nothing."""
    nd = a.ndim
    for ax in range(nd):
        n = spec.shards[ax]
        if n == 1:
            continue
        name = spec.axis_names[ax]
        idx = lax.axis_index(name)

        def at(i):
            return tuple(i if k == ax else slice(None) for k in range(nd))

        recv_lo = _shift(a[at(-2)], name, n, up=True)
        recv_hi = _shift(a[at(1)], name, n, up=False)
        a = a.at[at(0)].set(jnp.where(idx == 0, a[at(0)], recv_lo))
        a = a.at[at(-1)].set(jnp.where(idx == n - 1, a[at(-1)], recv_hi))
    return a


def _gsum(spec: MGDecomp, x):
    s = jnp.sum(x)
    for name in spec.axis_names:
        if name is not None:
            s = lax.psum(s, name)
    return s


def _gmax(spec: MGDecomp, x):
    m = jnp.max(x)
    for name in spec.axis_names:
        if name is not None:
            m = lax.pmax(m, name)
    return m


def _allgather_nd(spec: MGDecomp, x):
    """Assemble the full global array (replicated) from local blocks."""
    for ax in range(x.ndim):
        if spec.shards[ax] > 1:
            x = lax.all_gather(x, spec.axis_names[ax], axis=ax, tiled=True)
    return x


def _local_slice(spec: MGDecomp, full, local_shape):
    """This shard's block of a replicated full array."""
    # normalize to one index dtype: axis_index is int32, unsharded axes
    # contribute Python ints (int64 under x64) — dynamic_slice rejects a mix
    starts = tuple(jnp.asarray(spec.idx(ax) * local_shape[ax], jnp.int32)
                   for ax in range(full.ndim))
    return lax.dynamic_slice(full, starts, local_shape)


def _coeffs_dist(local_shape, global_shape, offsets, inv2, dtype):
    """ops.mg._coeffs with GLOBAL indices on a local block: identical
    per-cell arithmetic (same accumulation order, same cval cast), edge
    zeros only at the global walls."""
    total = None
    axes = []
    zero = jnp.zeros((), dtype)
    for ax, c in enumerate(inv2):
        idx = (lax.broadcasted_iota(jnp.int32, local_shape, ax)
               + offsets[ax])
        cval = jnp.asarray(np.float64(c).astype(dtype))
        apl = jnp.where(idx == global_shape[ax] - 1, zero, cval)
        ami = jnp.where(idx == 0, zero, cval)
        pair = apl + ami
        total = pair if total is None else total + pair
        axes.append((apl, ami))
    ap = -total
    ap_inv = -1.0 / total
    return axes, ap, ap_inv


def _red_mask_dist(local_shape, offsets):
    """(global i + global j [+ global k]) % 2 == 0 on the local block."""
    s = None
    for ax in range(len(local_shape)):
        idx = (lax.broadcasted_iota(jnp.int32, local_shape, ax)
               + offsets[ax])
        s = idx if s is None else s + idx
    return (s % 2) == 0


def _neigh_g(axes, pg, rhs):
    """ops.mg._neigh on a GHOSTED local block: the serial roll-with-zero-
    coeff form becomes ghost-shell slices (wall ghosts are zeros times an
    exactly-zero coefficient; shard-boundary ghosts carry neighbor data).
    Same per-axis subtraction order as serial."""
    nd = rhs.ndim
    out = rhs

    def sl(ax, lo, hi):
        return tuple(slice(lo, hi) if k == ax else slice(1, -1)
                     for k in range(nd))

    for ax, (apl, ami) in enumerate(axes):
        out = (out - apl * pg[sl(ax, 2, None)]
               - ami * pg[sl(ax, 0, -2)])
    return out


def _rb_sweep_dist(spec, axes, ap_inv, red, p, rhs):
    """One red-black Gauss-Seidel sweep on an interior-shaped local block:
    ghost-pad + exchange before each half-sweep (each color must read the
    other color's fresh shard-boundary values, like dist.py's rbsor)."""
    for mask in (red, ~red):
        pg = _exchange_nd(spec, jnp.pad(p, 1))
        gs = _neigh_g(axes, pg, rhs) * ap_inv
        p = jnp.where(mask, gs, p)
    return p


def _prolong_axis_dist(spec, e, ax):
    """ops.mg._prolong_axis with the edge clamp replaced by the true
    neighbor value at shard boundaries (one extent-1 slice exchange)."""
    n = spec.shards[ax]
    first = lax.slice_in_dim(e, 0, 1, axis=ax)
    last = lax.slice_in_dim(e, e.shape[ax] - 1, e.shape[ax], axis=ax)
    if n == 1:
        ghost_lo, ghost_hi = first, last  # serial edge clamp
    else:
        name = spec.axis_names[ax]
        idx = lax.axis_index(name)
        from_lo = _shift(last, name, n, up=True)
        from_hi = _shift(first, name, n, up=False)
        ghost_lo = jnp.where(idx == 0, first, from_lo)
        ghost_hi = jnp.where(idx == n - 1, last, from_hi)
    lo = jnp.concatenate(
        [ghost_lo, lax.slice_in_dim(e, 0, e.shape[ax] - 1, axis=ax)],
        axis=ax)
    hi = jnp.concatenate(
        [lax.slice_in_dim(e, 1, e.shape[ax], axis=ax), ghost_hi], axis=ax)
    a = 0.25 * lo + 0.75 * e
    b = 0.75 * e + 0.25 * hi
    out = jnp.stack([a, b], axis=ax + 1)
    new_shape = e.shape[:ax] + (2 * e.shape[ax],) + e.shape[ax + 1:]
    return out.reshape(new_shape)


def _prolong_dist(spec, e):
    for ax in range(e.ndim):
        e = _prolong_axis_dist(spec, e, ax)
    return e


# Gather crossover: once a level's global volume is at or below this, the
# remaining ladder runs replicated after one all_gather. 64^2 / 16^3-class
# levels are latency-bound under per-half-sweep exchanges (each sweep is
# 2 exchanges for microseconds of compute); the gathered problem is a few
# KB riding one collective. Tests override it to force both extremes.
GATHER_VOLUME = 4096


def mg_solve_dist(spec: MGDecomp, p, rhs, inv2, tol, max_cycles,
                  nu: int | None = None, coarse_iters: int = 50,
                  tol_rel: float = 0.0,
                  gather_volume: int | None = None):
    """ops.mg.mg_solve on a sharded grid (call inside shard_map).

    p    — ghosted LOCAL block (ghosts untouched, as serial);
    rhs  — interior-shaped LOCAL right-hand side;
    spec — the shard layout (mesh axis name + shard count per array axis);
    remaining arguments exactly as ops.mg.mg_solve (the coarsening ladder,
    tolerance semantics — incl. sor_tol_rel with a GLOBAL pmax scale —
    and the V(1,1)/V(2,2) nu policy are shared, so trip counts match
    serial).

    Raises ValueError when the GLOBAL grid cannot be coarsened (same
    contract as serial; the local block may be as thin as one cell).
    """
    if gather_volume is None:  # late-bound so tests can patch the module
        gather_volume = GATHER_VOLUME
    nu = _nu_policy(nu, tol_rel)
    nd = rhs.ndim
    local0 = tuple(rhs.shape)
    gshape = tuple(l * s for l, s in zip(local0, spec.shards))
    shapes = mg_levels(gshape)
    if len(shapes) < 2:
        raise ValueError(
            f"pressure_solver='mg' needs a coarsenable interior grid "
            f"(all extents even and >= 8); got global {gshape} — use "
            f"'rbsor'")
    dtype = p.dtype
    npts = float(np.prod(gshape))

    def dist_ok(shape):
        return all(shape[ax] % spec.shards[ax] == 0 for ax in range(nd))

    # crossover: levels [0, L) run sharded, [L, end) replicated. L=0 =
    # fully replicated (tiny grids); L=len(shapes) = fully distributed.
    L = len(shapes)
    for lvl, shape in enumerate(shapes):
        if not dist_ok(shape) or int(np.prod(shape)) <= gather_volume:
            L = lvl
            break

    # sharded levels: coefficients/masks from GLOBAL indices
    dlevels = []
    for lvl in range(L):
        lshape = tuple(shapes[lvl][ax] // spec.shards[ax]
                       for ax in range(nd))
        offsets = tuple(spec.idx(ax) * lshape[ax] for ax in range(nd))
        axes, ap, ap_inv = _coeffs_dist(
            lshape, shapes[lvl], offsets,
            tuple(c / 4.0**lvl for c in inv2), dtype)
        dlevels.append((lshape, axes, ap, ap_inv,
                        _red_mask_dist(lshape, offsets)))

    # replicated tail: the serial vcycle on the sub-ladder (identical
    # arithmetic on every shard — no communication inside)
    if L < len(shapes):
        tail_shapes = shapes[L:]
        tail_levels = _build_levels(
            tail_shapes, tuple(c / 4.0**L for c in inv2), dtype)
        tail_vcycle = _make_vcycle(tail_shapes, tail_levels, dtype, nu,
                                   coarse_iters)

    interior = (slice(1, -1),) * nd
    p0 = p[interior]

    if L == 0:
        # fully replicated: gather the fine problem once, run the SERIAL
        # solver on every shard (bit-identical replicas, serial trip
        # counts), slice the local block back
        from ..ops.mg import mg_solve

        rhs_full = _allgather_nd(spec, rhs)
        p_full = jnp.zeros(tuple(n + 2 for n in gshape), dtype)
        p_full = p_full.at[interior].set(_allgather_nd(spec, p0))
        out = mg_solve(p_full, rhs_full, inv2, tol, max_cycles, nu=nu,
                       coarse_iters=coarse_iters, tol_rel=tol_rel)
        p_int = _local_slice(spec, out[interior], local0)
        return _exchange_nd(spec, p.at[interior].set(p_int))

    # nullspace projection + tolerance: global reductions so the effective
    # tol — hence the trip count — matches serial's jnp.mean/jnp.max
    rhs = rhs - _gsum(spec, rhs) / npts
    if tol_rel and tol_rel > 0.0:
        tol = jnp.maximum(tol, tol_rel * _gmax(spec, jnp.abs(rhs)))

    def vcycle(lvl, p_l, rhs_l):
        lshape, axes, ap, ap_inv, red = dlevels[lvl]
        if lvl == len(shapes) - 1:  # fully distributed coarsest level
            def body(_, q):
                return _rb_sweep_dist(spec, axes, ap_inv, red, q, rhs_l)
            return lax.fori_loop(0, coarse_iters, body, p_l)
        for _ in range(nu):
            p_l = _rb_sweep_dist(spec, axes, ap_inv, red, p_l, rhs_l)
        pg = _exchange_nd(spec, jnp.pad(p_l, 1))
        r = _neigh_g(axes, pg, rhs_l) - ap * p_l  # rhs - A p
        if lvl + 1 == L:
            # gather crossover: restrict shard-local when the next level
            # still divides the mesh (2^nd x less gathered data),
            # otherwise gather the residual and restrict replicated —
            # block means are per-cell independent, so both orders give
            # identical values
            if dist_ok(shapes[lvl + 1]):
                rhs_next = _allgather_nd(spec, _restrict(r))
            else:
                rhs_next = _restrict(_allgather_nd(spec, r))
            # rhs_next*0, not jnp.zeros: the tail's internal loop carries
            # must inherit the varying manual axes (cf. ops.mg._make_vcycle)
            e_full = tail_vcycle(0, rhs_next * 0.0, rhs_next)
            # prolong replicated (serial edge-clamp arithmetic), then
            # slice this shard's level-lvl block
            e = _local_slice(spec, _prolong(e_full), lshape)
        else:
            rn = _restrict(r)
            e = vcycle(lvl + 1, rn * 0.0, rn)
            e = _prolong_dist(spec, e)
        p_l = p_l + e
        for _ in range(nu):
            p_l = _rb_sweep_dist(spec, axes, ap_inv, red, p_l, rhs_l)
        return p_l

    _, axes0, ap0, ap_inv0, _ = dlevels[0]

    def resid(p_l):
        pg = _exchange_nd(spec, jnp.pad(p_l, 1))
        r = _neigh_g(axes0, pg, rhs) - ap0 * p_l
        r = r - _gsum(spec, r) / npts
        return _gmax(spec, jnp.abs(r))

    # outer loop: identical exits to ops.mg.mg_solve (stall carry on
    # globally-reduced residuals — every shard sees the same scalars)
    STALL_CYCLES = 4

    def cond(carry):
        p_l, it, r, best, stall = carry
        floored = (stall >= STALL_CYCLES) & (r <= 2.0 * best)
        return (it < max_cycles) & (r > tol) & ~floored

    def body(carry):
        p_l, it, r, best, stall = carry
        p_l = vcycle(0, p_l, rhs)
        r = resid(p_l)
        improved = r < best
        best = jnp.minimum(best, r)
        stall = jnp.where(improved, 0, stall + 1)
        return p_l, it + 1, r, best, stall

    i0 = jnp.zeros((), jnp.int32)
    r0 = resid(p0)
    p_int, *_ = lax.while_loop(cond, body, (p0, i0, r0, r0, i0))
    # refresh the shard-boundary ghost shell: the velocity correction reads
    # p's face neighbors, and in serial those ghosts ARE interior cells of
    # the just-solved field (rbsor keeps them fresh via its per-half-sweep
    # exchange; the V-cycle updates interiors only)
    return _exchange_nd(spec, p.at[interior].set(p_int))
