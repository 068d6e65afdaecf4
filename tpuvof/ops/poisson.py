"""Chorin pressure projection: fixed-iteration Jacobi Poisson solve.

Re-derivation of the reference `solve_p_jacobi` (2dvof.py:236-266): a 5-point
variable-free stencil whose edge coefficients are zeroed for the pure-Neumann
walls, iterated a *fixed* number of times with no residual check (the
reference runs a host loop of 10 kernel launches, 2dvof.py:521-522; here the
iterations are a `lax.fori_loop` inside one jitted computation — zero host
round trips).

The reference recomputes the identical rhs inside every Jacobi launch; the
rhs is loop-invariant, so here it is computed once (bitwise the same values).

Two autodiff modes (selected via Numerics.pressure_adjoint):
  - 'unrolled': differentiate straight through the iterations — the exact
    semantics of diff_vof.py:275-291 (which stores every Jacobi iterate).
    Under `jax.checkpoint` the iterates are rematerialized, not stored.
  - 'selfadjoint': a `jax.custom_vjp` mirroring the hand-written adjoint of
    diff_vof_replaced.py:303-330 — the backward pass runs the *same* Jacobi
    stencil on the cotangent (the truncated solve is treated as a linear
    solve with a self-adjoint operator), so nothing but the result needs to
    be saved.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Numerics
from ..grid import Grid2D
from .common import win

__all__ = ["poisson_coefficients", "divergence_rhs", "solve_pressure",
           "solve_pressure_counted",
           "rbsor_counted"]


def poisson_coefficients(g: Grid2D, dtype=np.float32):
    """Static 5-point coefficients with Neumann-edge zeroing
    (reference 2dvof.py:258-262). Interior-shaped (nx, ny).

    Built ON-DEVICE from iota masks selecting the 9 f64-precomputed
    edge-class values (same accumulation order before the dtype cast), so
    the jitted program carries no O(volume) constants: at 4096^2 they
    would be 5 x 67 MB of program."""
    dxi2 = np.float64(g.dxi) ** 2
    dyi2 = np.float64(g.dyi) ** 2
    shape = (g.nx, g.ny)
    i = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    cx = jnp.asarray(dxi2.astype(dtype))
    cy = jnp.asarray(dyi2.astype(dtype))
    zero = jnp.zeros((), dtype)
    ae = jnp.where(i == g.nx - 1, zero, cx)
    aw = jnp.where(i == 0, zero, cx)
    an = jnp.where(j == g.ny - 1, zero, cy)
    a_s = jnp.where(j == 0, zero, cy)

    def const(ex, ey):
        # ((ae + aw) + an) + a_s in f64, cast after — the numpy form's order
        t = dxi2 if ex else dxi2 + dxi2
        for _ in range(2 - ey):
            t = t + dyi2
        return jnp.asarray((-1.0 / t).astype(dtype))

    ex = (i == 0) | (i == g.nx - 1)
    ey = (j == 0) | (j == g.ny - 1)
    ap_inv = jnp.where(
        ex,
        jnp.where(ey, const(1, 1), const(1, 0)),
        jnp.where(ey, const(0, 1), const(0, 0)),
    )
    return ae, aw, an, a_s, ap_inv


def divergence_rhs(g: Grid2D, nm: Numerics, u_star, v_star, rho):
    """rhs = rho/dt * div(u*) on the interior (reference 2dvof.py:239-241)."""
    ri = (1, g.nx + 1)
    rj = (1, g.ny + 1)
    return (
        win(rho, ri, rj)
        / nm.dt
        * (
            (win(u_star, ri, rj, 1, 0) - win(u_star, ri, rj)) * g.dxi
            + (win(v_star, ri, rj, 0, 1) - win(v_star, ri, rj)) * g.dyi
        )
    )


def _jacobi_sweeps(g: Grid2D, n_iter: int, p, rhs):
    """n_iter Jacobi updates of the interior; ghost p entries are never read
    (their coefficients are zero) nor written, as in the reference."""
    ae, aw, an, a_s, ap_inv = poisson_coefficients(g, p.dtype)
    ri = (1, g.nx + 1)
    rj = (1, g.ny + 1)

    def body(_, p):
        p_int = (
            rhs
            - ae * win(p, ri, rj, 1, 0)
            - aw * win(p, ri, rj, -1, 0)
            - an * win(p, ri, rj, 0, 1)
            - a_s * win(p, ri, rj, 0, -1)
        ) * ap_inv
        return p.at[1:-1, 1:-1].set(p_int)

    return jax.lax.fori_loop(0, n_iter, body, p, unroll=True)


@partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _jacobi_selfadjoint(g: Grid2D, n_iter: int, p, rhs):
    return _jacobi_sweeps(g, n_iter, p, rhs)


def _jacobi_sa_fwd(g, n_iter, p, rhs):
    return _jacobi_sweeps(g, n_iter, p, rhs), None


def _jacobi_sa_bwd(g, n_iter, _res, g_out):
    # Mirrors diff_vof_replaced.py:303-330: iterate the same stencil on the
    # cotangent of p to produce the cotangent of rhs; the initial-pressure
    # dependence is dropped (the truncated solve is treated as converged).
    g_p_int = g_out[1:-1, 1:-1]
    g_rhs = jnp.zeros_like(g_out)
    ae, aw, an, a_s, ap_inv = poisson_coefficients(g, g_out.dtype)
    ri = (1, g.nx + 1)
    rj = (1, g.ny + 1)

    def body(_, y):
        y_int = (
            g_p_int
            - ae * win(y, ri, rj, 1, 0)
            - aw * win(y, ri, rj, -1, 0)
            - an * win(y, ri, rj, 0, 1)
            - a_s * win(y, ri, rj, 0, -1)
        ) * ap_inv
        return y.at[1:-1, 1:-1].set(y_int)

    g_rhs = jax.lax.fori_loop(0, n_iter, body, g_rhs, unroll=True)
    return jnp.zeros_like(g_out), g_rhs[1:-1, 1:-1]


_jacobi_selfadjoint.defvjp(_jacobi_sa_fwd, _jacobi_sa_bwd)


def solve_pressure(g: Grid2D, nm: Numerics, p, u_star, v_star, rho):
    """`solve_pressure_counted` without the iteration count."""
    return solve_pressure_counted(g, nm, p, u_star, v_star, rho)[0]


def solve_pressure_counted(g: Grid2D, nm: Numerics, p, u_star, v_star, rho):
    """Full pressure solve: rhs assembly + the configured iteration;
    returns (p, iterations taken: Jacobi sweeps, red+black iterations or
    V-cycles).

    With pressure_adjoint='selfadjoint' every rung of the ladder is
    differentiable: the truncated Jacobi through the reference-pattern
    adjoint (_jacobi_selfadjoint), the converged rbsor/mg through the
    implicit-function adjoint (one more converged solve on the projected
    cotangent). 'unrolled' differentiates through the
    Jacobi iterations only; the residual-driven while_loops cannot
    unroll."""
    rhs = divergence_rhs(g, nm, u_star, v_star, rho)
    sa = nm.pressure_adjoint == "selfadjoint"
    if nm.pressure_solver == "rbsor":
        fn = _rbsor_implicit if sa else rbsor_counted
        return fn(g, nm, p, rhs)
    if nm.pressure_solver == "mg":
        from .mg import mg_solve_counted, mg_solve_implicit_counted

        fn = mg_solve_implicit_counted if sa else mg_solve_counted
        return fn(p, rhs, (g.dxi**2, g.dyi**2), nm.sor_tol,
                  nm.sor_max_iter, tol_rel=nm.sor_tol_rel)
    if nm.pressure_solver != "jacobi":
        raise ValueError(
            f"unknown pressure_solver {nm.pressure_solver!r} "
            "(expected 'jacobi', 'rbsor', or 'mg')")
    fn = _jacobi_selfadjoint if sa else _jacobi_sweeps
    return fn(g, nm.n_jacobi, p, rhs), nm.n_jacobi


def residual(g: Grid2D, p, rhs, project_nullspace: bool = True):
    """max |A p - rhs| over the interior (the convergence measure the
    reference never computes — SURVEY.md §2.5.1).

    The pure-Neumann operator is singular (constant nullspace): an
    incompatible rhs (nonzero mean) leaves an irreducible residual component
    no iteration can remove. With ``project_nullspace`` the mean is
    subtracted first so the measure reflects only the solvable part — this
    is what the RB-SOR stopping test uses.
    """
    ae, aw, an, a_s, ap_inv = poisson_coefficients(g, p.dtype)
    ri = (1, g.nx + 1)
    rj = (1, g.ny + 1)
    ap = 1.0 / ap_inv
    r = (
        rhs
        - ae * win(p, ri, rj, 1, 0)
        - aw * win(p, ri, rj, -1, 0)
        - an * win(p, ri, rj, 0, 1)
        - a_s * win(p, ri, rj, 0, -1)
        - ap * win(p, ri, rj)
    )
    if project_nullspace:
        r = r - jnp.mean(r)
    return jnp.max(jnp.abs(r))


#: Residual-driven solvers stop early when `STALL_ITERS` consecutive
#: iterations produce no new best residual AND the residual sits at that
#: best (within PLATEAU_FACTOR): at f32 the achievable floor can sit ABOVE
#: sor_tol (mg at 512^2 can stall near rel 6e-4 of a developed-flow r0),
#: and without the stall exit the while_loop burns the full iteration cap
#: at the floor. The plateau guard matters for SOR at omega near 2, whose
#: residuals OSCILLATE for hundreds of iterations before converging (at
#: omega=1.9878 an unguarded stall exit fired at r = 2.8x r0; guarded, it
#: converges) — non-monotone phases keep r far above best, so the exit
#: only fires at a genuine floor.
STALL_ITERS = 25
PLATEAU_FACTOR = 2.0


def effective_tol(tol: float, tol_rel: float, rhs_projected):
    """Stopping tolerance for a residual-driven solve: the absolute
    ``tol``, raised to ``tol_rel * max|rhs'|`` when a relative tolerance
    is configured (Numerics.sor_tol_rel). ``rhs_projected`` must already
    be nullspace-projected (mean-free) — the scale then matches the
    initial residual of a zero guess, so ``tol_rel`` reads as "reduce
    the divergence residual to this fraction of its source scale".
    ``tol_rel`` is a Python float: at 0.0 (the default) the traced
    program is unchanged (the tolerance stays a compile-time constant,
    preserving the existing programs and their parity pins)."""
    if tol_rel and tol_rel > 0.0:
        return jnp.maximum(tol, tol_rel * jnp.max(jnp.abs(rhs_projected)))
    return tol


def _rbsor(g: Grid2D, nm: Numerics, p, rhs):
    """`rbsor_counted` without the iteration count."""
    return rbsor_counted(g, nm, p, rhs)[0]


def rbsor_counted(g: Grid2D, nm: Numerics, p, rhs):
    """Red-black successive over-relaxation with an on-device residual
    stop; returns (p, number of red+black iterations taken).

    An upgrade path over the reference's fixed 10 Jacobi sweeps
    (2dvof.py:521-522, which leave an O(1) divergence residual): each RB-SOR
    iteration converges like ~2 Jacobi iterations at omega≈1.7, and the
    `lax.while_loop` exits as soon as max|Ap - rhs| <= sor_tol — all on
    device, no host sync — or at the dtype's residual floor (STALL_ITERS
    with no new best). Not differentiable (while_loop); the diff path
    keeps the fixed-iteration solvers.
    """
    # The pure-Neumann system only has a solution for a mean-free rhs; the
    # physical rhs carries a small incompatibility (net divergence is not
    # exactly zero), which would both stall the iteration at a floor and
    # defeat the residual stop. Solving against the projected rhs is the
    # standard treatment (pressure is defined up to a constant anyway).
    # The reference-parity 'jacobi' mode deliberately does NOT do this.
    rhs = rhs - jnp.mean(rhs)
    tol = effective_tol(nm.sor_tol, nm.sor_tol_rel, rhs)
    ae, aw, an, a_s, ap_inv = poisson_coefficients(g, p.dtype)
    ri = (1, g.nx + 1)
    rj = (1, g.ny + 1)
    # on-device checkerboard (a baked numpy bool is an O(n^2) program
    # literal; cf. poisson_coefficients)
    red = ((jax.lax.broadcasted_iota(jnp.int32, (g.nx, g.ny), 0)
            + jax.lax.broadcasted_iota(jnp.int32, (g.nx, g.ny), 1))
           % 2 == 0)
    omega = nm.sor_omega

    def half_sweep(p, mask):
        gs = (
            rhs
            - ae * win(p, ri, rj, 1, 0)
            - aw * win(p, ri, rj, -1, 0)
            - an * win(p, ri, rj, 0, 1)
            - a_s * win(p, ri, rj, 0, -1)
        ) * ap_inv
        p_int = win(p, ri, rj)
        upd = p_int + omega * (gs - p_int)
        return p.at[1:-1, 1:-1].set(jnp.where(mask, upd, p_int))

    def cond(carry):
        p, it, r, best, stall = carry
        floored = (stall >= STALL_ITERS) & (r <= PLATEAU_FACTOR * best)
        return (it < nm.sor_max_iter) & (r > tol) & ~floored

    def body(carry):
        p, it, r, best, stall = carry
        p = half_sweep(p, red)
        p = half_sweep(p, ~red)
        r = residual(g, p, rhs)
        improved = r < best
        best = jnp.minimum(best, r)
        stall = jnp.where(improved, 0, stall + 1)
        return p, it + 1, r, best, stall

    i0 = jnp.zeros((), jnp.int32)
    r0 = residual(g, p, rhs)
    p, it, *_ = jax.lax.while_loop(cond, body, (p, i0, r0, r0, i0))
    return p, it


# Implicit-function adjoint for the converged RB-SOR solve (the rbsor
# twin of ops.mg._mg_implicit — see the derivation there):
# A is symmetric, so rhs_bar = P _rbsor(P p_bar) with P the nullspace
# (mean) projection; the warm start carries no gradient. Returns
# (p, iterations), as rbsor_counted.
@partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _rbsor_implicit(g: Grid2D, nm: Numerics, p, rhs):
    return rbsor_counted(g, nm, p, rhs)


def _rbsor_impl_fwd(g, nm, p, rhs):
    return rbsor_counted(g, nm, p, rhs), None


def _rbsor_impl_bwd(g, nm, _res, g_out):
    g_out = g_out[0]  # the iteration count carries no cotangent
    gbar = g_out[1:-1, 1:-1]
    gbar = gbar - jnp.mean(gbar)
    y = _rbsor(g, nm, jnp.zeros_like(g_out), gbar)[1:-1, 1:-1]
    return jnp.zeros_like(g_out), y - jnp.mean(y)


_rbsor_implicit.defvjp(_rbsor_impl_fwd, _rbsor_impl_bwd)
