"""Geometric multigrid for the edge-zeroed pure-Neumann Poisson operator.

The third rung of the pressure-solver ladder (``Numerics.pressure_solver``):

  'jacobi'  — the reference's fixed-iteration sweeps, no residual check
              (2dvof.py:521-522; bit-parity path)
  'rbsor'   — red-black SOR iterated to an on-device residual tolerance
              (ops/poisson._rbsor / solver3d._rbsor_3d)
  'mg'      — THIS module: V-cycles over a rediscretized grid hierarchy.
              Same contract as 'rbsor' (solve to max|Ap-rhs| <= sor_tol on
              the nullspace-projected system), but the iteration count is
              O(1) in grid size instead of O(n): at 1024^2 mg reaches
              rel-1e-3 in O(10) V-cycles where rbsor at the default omega
              runs to its cap and still stalls at 2.3e-2*r0; 'auto'
              resolves to mg for serial runs.

Dimension-generic (one implementation serves the 2-D and 3-D drivers):
every level operates on *interior-shaped* arrays, and the per-level
operator reuses the reference's edge-coefficient-zeroing form
(2dvof.py:258-262, here per level) — which makes `jnp.roll` a safe shift
(wrap-around neighbors are multiplied by an exactly-zero coefficient).

Scheme choices (cell-centered MG, Wesseling-standard):
  - smoother: red-black Gauss-Seidel (omega=1), nu=2 pre + 2 post sweeps;
  - restriction: per-axis pairwise mean (block mean — full weighting for
    cell-centered grids, preserves mean-free rhs exactly);
  - prolongation: per-axis linear interpolation with edge clamp
    (bi/tri-linear; the clamp is the homogeneous-Neumann extension);
  - coarsest level: 50 red-black sweeps;
  - coarsening stops when any extent goes odd or would drop below 4, so
    non-power-of-two grids (the reference's 200^2 / 200^3) coarsen as far
    as they can and the residual-driven outer loop absorbs the rest.

Every level's operator is singular with the constant nullspace (row sums
are zero by construction and the operator is symmetric), the block-mean
restriction keeps residuals mean-free, so each coarse problem stays
compatible; the constant component of a coarse correction only shifts p
by a constant, which pressure is defined up to anyway.

Differentiable through `mg_solve_implicit` (implicit-function
custom_vjp: the adjoint is ONE more mg solve on the projected cotangent
— A is symmetric; see the block above it); plain `mg_solve`'s outer
`lax.while_loop` is not unrollable, so pressure_adjoint='unrolled'
still requires the fixed-iteration solvers. Distributed runs
use parallel/mg.py (sharded fine smoothing, replicated coarse tail
through _make_vcycle below — its serial-parity contract); 'auto'
resolves to mg wherever the global grid coarsens, serial and
distributed (solver.resolve_auto, Decomp, Decomp3D).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["mg_solve", "mg_solve_counted", "mg_solve_implicit",
           "mg_solve_implicit_counted", "mg_levels"]


def mg_levels(shape) -> list[tuple[int, ...]]:
    """The coarsening ladder for an interior shape: halve every axis while
    all extents are even and stay >= 4. [(fine), ..., (coarsest)]."""
    shapes = [tuple(int(n) for n in shape)]
    while all(n % 2 == 0 and n // 2 >= 4 for n in shapes[-1]):
        shapes.append(tuple(n // 2 for n in shapes[-1]))
    return shapes


def _coeffs(shape, inv2, dtype):
    """Edge-zeroed Neumann coefficients for one level, interior-shaped.

    Returns ([(a_plus, a_minus) per axis], ap, ap_inv) where a_plus[idx]
    multiplies the +1 neighbor along that axis (zero on the last slice =
    the wall, reference 2dvof.py:258-262) — built ON-DEVICE from iota
    masks (the former numpy constant volumes were baked into the trace:
    ~8 x 67 MB of program literals at a 256^3 fine level, past the remote
    compile service's request limit; cf. solver3d._poisson_coeffs_3d).
    ap/ap_inv accumulate in the working dtype on device — mg has no
    bit-parity oracle (no reference counterpart), and the f64 CPU tests
    see identical arithmetic.
    """
    import jax.lax as lax

    nd = len(shape)
    total = None
    axes = []
    zero = jnp.zeros((), dtype)
    for ax, c in enumerate(inv2):
        idx = lax.broadcasted_iota(jnp.int32, shape, ax)
        cval = jnp.asarray(np.float64(c).astype(dtype))
        apl = jnp.where(idx == shape[ax] - 1, zero, cval)
        ami = jnp.where(idx == 0, zero, cval)
        pair = apl + ami
        total = pair if total is None else total + pair
        axes.append((apl, ami))
    ap = -total
    ap_inv = -1.0 / total
    return axes, ap, ap_inv


def _neigh(axes, p, rhs):
    """rhs - sum(neighbor contributions); roll wrap is killed by the zero
    edge coefficients (p[i+1] on an interior array is roll(p, -1))."""
    out = rhs
    for ax, (apl, ami) in enumerate(axes):
        out = out - apl * jnp.roll(p, -1, ax) - ami * jnp.roll(p, 1, ax)
    return out


def _red_mask(shape):
    """(i+j[+k]) % 2 == 0, built on-device (a baked numpy bool volume is
    an O(volume) program literal, cf. _coeffs)."""
    import jax.lax as lax

    s = None
    for ax in range(len(shape)):
        idx = lax.broadcasted_iota(jnp.int32, shape, ax)
        s = idx if s is None else s + idx
    return (s % 2) == 0


def _rb_sweep(axes, ap_inv, red, p, rhs):
    """One full red-black Gauss-Seidel sweep (two half sweeps)."""
    for mask in (red, ~red):
        gs = _neigh(axes, p, rhs) * ap_inv
        p = jnp.where(mask, gs, p)
    return p


def _restrict(r):
    """Per-axis pairwise mean (cell-centered full weighting)."""
    for ax in range(r.ndim):
        n = r.shape[ax]
        new_shape = r.shape[:ax] + (n // 2, 2) + r.shape[ax + 1:]
        r = r.reshape(new_shape).mean(axis=ax + 1)
    return r


def _prolong_axis(e, ax):
    lo = jnp.concatenate([jax.lax.slice_in_dim(e, 0, 1, axis=ax),
                          jax.lax.slice_in_dim(e, 0, e.shape[ax] - 1, axis=ax)],
                         axis=ax)
    hi = jnp.concatenate([jax.lax.slice_in_dim(e, 1, e.shape[ax], axis=ax),
                          jax.lax.slice_in_dim(e, e.shape[ax] - 1, e.shape[ax],
                                               axis=ax)],
                         axis=ax)
    a = 0.25 * lo + 0.75 * e  # fine cell 2i   (nearer the i-1 coarse cell)
    b = 0.75 * e + 0.25 * hi  # fine cell 2i+1 (nearer the i+1 coarse cell)
    out = jnp.stack([a, b], axis=ax + 1)
    new_shape = e.shape[:ax] + (2 * e.shape[ax],) + e.shape[ax + 1:]
    return out.reshape(new_shape)


def _prolong(e):
    """Bi/tri-linear cell-centered interpolation (edge-clamped)."""
    for ax in range(e.ndim):
        e = _prolong_axis(e, ax)
    return e


def _nu_policy(nu, tol_rel) -> int:
    """Resolve nu=None to the measured smoothing policy (see mg_solve):
    V(1,1) in the bounded-cost relative mode, V(2,2) otherwise. One
    function so the serial and distributed solvers cannot drift apart
    (identical nu is part of their 1e-12 parity contract)."""
    if nu is None:
        return 1 if (tol_rel and tol_rel > 0.0) else 2
    return nu


def _build_levels(shapes, inv2, dtype):
    """Per-level (axes, ap, ap_inv, red_mask) for a coarsening ladder;
    ``inv2`` is the 1/h^2 tuple at shapes[0] (each level divides by 4)."""
    levels = []
    for lvl, shape in enumerate(shapes):
        axes, ap, ap_inv = _coeffs(shape,
                                   tuple(c / 4.0**lvl for c in inv2), dtype)
        levels.append((axes, ap, ap_inv, _red_mask(shape)))
    return levels


def _make_vcycle(shapes, levels, dtype, nu: int, coarse_iters: int):
    """The recursive V-cycle over a (sub-)ladder: vcycle(lvl, p, rhs) on
    interior-shaped arrays. Factored out of mg_solve so the distributed
    solver (parallel/mg.py) can run the replicated coarse tail through
    the EXACT serial arithmetic (its 1e-12 serial-parity contract)."""

    def vcycle(lvl, p_l, rhs_l):
        axes, ap, ap_inv, red = levels[lvl]
        if lvl == len(levels) - 1:
            def body(_, q):
                return _rb_sweep(axes, ap_inv, red, q, rhs_l)
            return jax.lax.fori_loop(0, coarse_iters, body, p_l)
        for _ in range(nu):
            p_l = _rb_sweep(axes, ap_inv, red, p_l, rhs_l)
        r = _neigh(axes, p_l, rhs_l) - ap * p_l  # rhs - A p
        rn = _restrict(r)
        # zero initial error as rn*0, not jnp.zeros: under shard_map the
        # loop carry must inherit rn's varying manual axes (a fresh
        # constant is device-invariant and trips the vma check); XLA
        # folds the multiply, and plain serial traces are unaffected
        e = vcycle(lvl + 1, rn * 0.0, rn)
        p_l = p_l + _prolong(e)
        for _ in range(nu):
            p_l = _rb_sweep(axes, ap_inv, red, p_l, rhs_l)
        return p_l

    return vcycle


def mg_solve(p, rhs, inv2, tol, max_cycles, nu: int | None = None,
             coarse_iters: int = 50, tol_rel: float = 0.0):
    """`mg_solve_counted` without the V-cycle count."""
    return mg_solve_counted(p, rhs, inv2, tol, max_cycles, nu,
                            coarse_iters, tol_rel)[0]


def mg_solve_counted(p, rhs, inv2, tol, max_cycles, nu: int | None = None,
                     coarse_iters: int = 50, tol_rel: float = 0.0):
    """Solve the interior pressure system by residual-driven V-cycles;
    returns (p, number of V-cycles taken).

    p     — full ghosted array (ghosts untouched, as in the reference);
    rhs   — interior-shaped right-hand side;
    inv2  — per-axis 1/h^2 at the fine level (g.dxi**2, g.dyi**2[, g.dzi**2]);
    tol   — stop when max|Ap - rhs| (nullspace-projected) <= tol;
    max_cycles — V-cycle cap (the while_loop bound);
    tol_rel — when > 0, raise tol to tol_rel * max|rhs'| of THIS solve
              (Numerics.sor_tol_rel; ops.poisson.effective_tol) — the
              bounded-cost production mode: a warm-started per-step
              solve terminates after O(1) V-cycles instead of running
              to the f32 floor + stall exit every step.
    nu    — pre/post smoothing sweeps per level; None = V(1,1) in the
            relative mode, V(2,2) otherwise: in warm-started rel=1e-2
            production steps the extra cycles of V(1,1) cost less than
            the extra sweeps of V(2,2), while V(3,3) buys nothing; the
            absolute/floor regime keeps V(2,2), whose contraction the
            ≥10×-per-cycle test pins. On the H100 this choice is not
            measured yet.

    Raises ValueError if the grid cannot be coarsened at all (every axis
    odd or < 8) — use pressure_solver='rbsor' there.
    """
    nu = _nu_policy(nu, tol_rel)
    nd = rhs.ndim
    shapes = mg_levels(rhs.shape)
    if len(shapes) < 2:
        raise ValueError(
            f"pressure_solver='mg' needs a coarsenable interior grid "
            f"(all extents even and >= 8); got {rhs.shape} — use 'rbsor'")
    dtype = p.dtype
    levels = _build_levels(shapes, inv2, dtype)

    # pure-Neumann compatibility: solve against the projected rhs (pressure
    # is defined up to a constant); same treatment as _rbsor.
    rhs = rhs - jnp.mean(rhs)
    from .poisson import effective_tol

    tol = effective_tol(tol, tol_rel, rhs)

    vcycle = _make_vcycle(shapes, levels, dtype, nu, coarse_iters)

    axes0, ap0, ap_inv0, _ = levels[0]

    def resid(p_l):
        r = _neigh(axes0, p_l, rhs) - ap0 * p_l
        r = r - jnp.mean(r)
        return jnp.max(jnp.abs(r))

    interior = (slice(1, -1),) * nd

    # stall exit: at f32 the achievable residual floor can sit above tol
    # (512^2 developed-flow solves can stall near rel 6e-4 of r0);
    # STALL_CYCLES cycles with no new best residual = done.
    # Each V-cycle contracts the residual ~10-50x while converging, so
    # the exit cannot fire during genuine convergence.
    STALL_CYCLES = 4

    def cond(carry):
        p_l, it, r, best, stall = carry
        # plateau guard as in ops.poisson (V-cycle residuals are monotone
        # in practice, but keep the exits semantically identical)
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

    p0 = p[interior]
    r0 = resid(p0)
    # r0-derived int counters, not fresh zeros: when this runs REPLICATED
    # inside shard_map (parallel/mg.py's gathered-fine-problem path) the
    # it/stall carries must inherit r0's varying manual axes. NaN-safe
    # form (ADVICE r4): r0*0.0 is NaN for an Inf r0 (diverged f32 state)
    # and NaN->int32 is implementation-defined, which could defeat the
    # max_cycles cap; (r0 != r0) is a plain bool for every r0.
    i0 = (r0 != r0).astype(jnp.int32) * 0
    p_int, it, *_ = jax.lax.while_loop(cond, body, (p0, i0, r0, r0, i0))
    return p.at[interior].set(p_int), it


# ----------------------------------------------------------------------
# Differentiable converged projection (VERDICT r4 #4): implicit-function
# custom_vjp. At convergence p solves A p = P rhs (P = mean projection,
# pressure defined up to a constant), so by the implicit function theorem
# d p = A^+ P d rhs and, with A symmetric (the edge-zeroed pure-Neumann
# operator: row i's coupling to j equals row j's to i by construction),
#   rhs_bar = P A^+ p_bar — i.e. ONE MORE mg solve on the projected
# cotangent, exactly the pattern of the reference's hand-written Jacobi
# adjoint (diff_vof_replaced.py:303-330) upgraded from "same truncated
# iteration" to "same converged solver". Nothing is saved between fwd
# and bwd; the warm-start p carries no gradient (a converged solve does
# not depend on its initial guess beyond the nullspace constant, which
# the projection kills), matching _jacobi_selfadjoint's contract.
# ----------------------------------------------------------------------
from functools import partial as _partial


@_partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 3, 4, 5))
def _mg_implicit(inv2, tol, max_cycles, nu, coarse_iters, tol_rel, p, rhs):
    return mg_solve_counted(p, rhs, inv2, tol, max_cycles, nu=nu,
                            coarse_iters=coarse_iters, tol_rel=tol_rel)


def _mg_implicit_fwd(inv2, tol, max_cycles, nu, coarse_iters, tol_rel,
                     p, rhs):
    return _mg_implicit(inv2, tol, max_cycles, nu, coarse_iters, tol_rel,
                        p, rhs), None


def _mg_implicit_bwd(inv2, tol, max_cycles, nu, coarse_iters, tol_rel,
                     _res, g_out):
    g_out = g_out[0]  # the V-cycle count carries no cotangent
    interior = (slice(1, -1),) * g_out.ndim
    gbar = g_out[interior]
    # the solve's output is defined up to a constant the downstream
    # pressure gradient never sees; project the cotangent so the adjoint
    # system is compatible (mg_solve projects again internally — this
    # keeps the tol_rel scale equal to the cotangent's solvable part)
    gbar = gbar - jnp.mean(gbar)
    y = mg_solve(jnp.zeros_like(g_out), gbar, inv2, tol, max_cycles,
                 nu=nu, coarse_iters=coarse_iters, tol_rel=tol_rel)
    y = y[interior]
    return jnp.zeros_like(g_out), y - jnp.mean(y)


_mg_implicit.defvjp(_mg_implicit_fwd, _mg_implicit_bwd)


def mg_solve_implicit(p, rhs, inv2, tol, max_cycles, nu: int | None = None,
                      coarse_iters: int = 50, tol_rel: float = 0.0):
    """`mg_solve_implicit_counted` without the V-cycle count."""
    return mg_solve_implicit_counted(p, rhs, inv2, tol, max_cycles, nu,
                                     coarse_iters, tol_rel)[0]


def mg_solve_implicit_counted(p, rhs, inv2, tol, max_cycles,
                              nu: int | None = None, coarse_iters: int = 50,
                              tol_rel: float = 0.0):
    """`mg_solve_counted` with the implicit-function adjoint: differentiable
    under `jax.grad` (the production 'mg' + pressure_adjoint=
    'selfadjoint' path; ops.poisson.solve_pressure routes here). The
    primal computation is mg_solve_counted itself — identical programs,
    identical values."""
    return _mg_implicit(tuple(float(c) for c in inv2), float(tol),
                        int(max_cycles), nu, int(coarse_iters),
                        float(tol_rel), p, rhs)
