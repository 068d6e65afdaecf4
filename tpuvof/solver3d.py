"""3-D time-step driver (reference 3dvof.py:598-627).

Experimental 3-D dam break: same pipeline as 2-D with w-momentum, a 7-point
Poisson stencil and three-way FCT sweep rotation; surface tension inert
(the reference's normals kernel is commented out, 3dvof.py:304-332, so
kappa stays zero and the sigma terms vanish identically — replicated here
by passing a zero kappa field).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .config import Fluid
from .grid import Grid3D
from .state import State3D, init_state_3d
from .ops import apply_bc_3d, clamp01, mix_properties
from .ops.fct3d import rudman_advect_3d
from .ops.momentum3d import predict_velocity_3d, update_velocity_3d

__all__ = ["step_3d", "simulate_3d", "init_state_3d"]


def _poisson_coeffs_3d(g: Grid3D, dtype):
    """7-point coefficients with Neumann-edge zeroing (3dvof.py:269-275).

    Built on device from iota masks selecting the f64-precomputed
    edge-class values (the ((((ae+aw)+an)+a_s)+ab)+af accumulation is done
    before the dtype cast), so the jitted program carries no whole-volume
    literals: at 256^3 seven constant volumes would be 7 x 67 MB of
    program."""
    dxi2 = np.float64(g.dxi) ** 2
    dyi2 = np.float64(g.dyi) ** 2
    dzi2 = np.float64(g.dzi) ** 2
    shape = (g.nx, g.ny, g.nz)
    i = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    k = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    cx = jnp.asarray(dxi2.astype(dtype))
    cy = jnp.asarray(dyi2.astype(dtype))
    cz = jnp.asarray(dzi2.astype(dtype))
    zero = jnp.zeros((), dtype)
    ae = jnp.where(i == g.nx - 1, zero, cx)
    aw = jnp.where(i == 0, zero, cx)
    an = jnp.where(j == g.ny - 1, zero, cy)
    a_s = jnp.where(j == 0, zero, cy)
    af = jnp.where(k == g.nz - 1, zero, cz)
    ab = jnp.where(k == 0, zero, cz)

    def const(ex, ey, ez):
        t = dxi2 if ex else dxi2 + dxi2
        for _ in range(2 - ey):
            t = t + dyi2
        for _ in range(2 - ez):
            t = t + dzi2
        return jnp.asarray((-1.0 / t).astype(dtype))

    ex = (i == 0) | (i == g.nx - 1)
    ey = (j == 0) | (j == g.ny - 1)
    ez = (k == 0) | (k == g.nz - 1)
    ap_inv = jnp.where(
        ex,
        jnp.where(ey, jnp.where(ez, const(1, 1, 1), const(1, 1, 0)),
                  jnp.where(ez, const(1, 0, 1), const(1, 0, 0))),
        jnp.where(ey, jnp.where(ez, const(0, 1, 1), const(0, 1, 0)),
                  jnp.where(ez, const(0, 0, 1), const(0, 0, 0))),
    )
    return ae, aw, an, a_s, af, ab, ap_inv


def _rhs_3d(g: Grid3D, dt, u_star, v_star, w_star, rho):
    I = (slice(1, -1),) * 3
    return rho[I] / dt * (
        (u_star[2:, 1:-1, 1:-1] - u_star[I]) * g.dxi
        + (v_star[1:-1, 2:, 1:-1] - v_star[I]) * g.dyi
        + (w_star[1:-1, 1:-1, 2:] - w_star[I]) * g.dzi
    )


def _neigh_3d(g: Grid3D, coeffs, p, rhs):
    ae, aw, an, a_s, af, ab, _ = coeffs
    return (
        rhs
        - ae * p[2:, 1:-1, 1:-1]
        - aw * p[:-2, 1:-1, 1:-1]
        - an * p[1:-1, 2:, 1:-1]
        - a_s * p[1:-1, :-2, 1:-1]
        - af * p[1:-1, 1:-1, 2:]
        - ab * p[1:-1, 1:-1, :-2]
    )


def _solve_pressure_3d(g: Grid3D, dt, n_iter, p, u_star, v_star, w_star, rho):
    rhs = _rhs_3d(g, dt, u_star, v_star, w_star, rho)
    coeffs = _poisson_coeffs_3d(g, p.dtype)
    ap_inv = coeffs[-1]
    I = (slice(1, -1),) * 3

    def body(_, p):
        return p.at[I].set(_neigh_3d(g, coeffs, p, rhs) * ap_inv)

    return jax.lax.fori_loop(0, n_iter, body, p, unroll=True)


def _rbsor_3d(g: Grid3D, p, rhs, omega: float, tol: float, max_iter: int,
              tol_rel: float = 0.0):
    """3-D red-black SOR with the on-device residual stop — the same
    upgrade path over the reference's fixed Jacobi sweeps that
    ops/poisson._rbsor gives the 2-D solver (the reference's 3-D loop
    also runs fixed 10 sweeps, 3dvof.py:598-623): coloring on
    (i+j+k) % 2, the rhs nullspace projected out (pure-Neumann system;
    pressure is defined up to a constant), `lax.while_loop` exits when
    max|Ap - rhs| <= tol — or at the dtype's residual floor
    (ops.poisson.STALL_ITERS with no new best AND plateaued; the f32
    case). Not differentiable (while_loop); the diff path keeps the
    fixed-iteration solvers."""
    from .ops.poisson import PLATEAU_FACTOR, STALL_ITERS, effective_tol
    rhs = rhs - jnp.mean(rhs)
    tol = effective_tol(tol, tol_rel, rhs)
    coeffs = _poisson_coeffs_3d(g, p.dtype)
    ap_inv = coeffs[-1]
    ap = 1.0 / ap_inv
    I = (slice(1, -1),) * 3
    # on-device checkerboard (a baked numpy bool is an O(n^3) program
    # literal; cf. _poisson_coeffs_3d)
    shp = (g.nx, g.ny, g.nz)
    red = ((jax.lax.broadcasted_iota(jnp.int32, shp, 0)
            + jax.lax.broadcasted_iota(jnp.int32, shp, 1)
            + jax.lax.broadcasted_iota(jnp.int32, shp, 2)) % 2 == 0)

    def half_sweep(p, mask):
        gs = _neigh_3d(g, coeffs, p, rhs) * ap_inv
        p_int = p[I]
        upd = p_int + omega * (gs - p_int)
        return p.at[I].set(jnp.where(mask, upd, p_int))

    def resid(p):
        r = _neigh_3d(g, coeffs, p, rhs) - ap * p[I]
        r = r - jnp.mean(r)
        return jnp.max(jnp.abs(r))

    def cond(carry):
        p, it, r, best, stall = carry
        floored = (stall >= STALL_ITERS) & (r <= PLATEAU_FACTOR * best)
        return (it < max_iter) & (r > tol) & ~floored

    def body(carry):
        p, it, r, best, stall = carry
        p = half_sweep(p, red)
        p = half_sweep(p, ~red)
        r = resid(p)
        improved = r < best
        best = jnp.minimum(best, r)
        stall = jnp.where(improved, 0, stall + 1)
        return p, it + 1, r, best, stall

    i0 = jnp.zeros((), jnp.int32)
    r0 = resid(p)
    p, *_ = jax.lax.while_loop(cond, body, (p, i0, r0, r0, i0))
    return p


def _resolve_auto_3d(g: Grid3D) -> str:
    """pressure_solver='auto', 3-D: 'mg' wherever the grid coarsens,
    'rbsor' otherwise — the same policy as solver.resolve_auto and the
    distributed drivers (mg_solve raises on non-coarsenable grids)."""
    from .ops.mg import mg_levels

    return "mg" if len(mg_levels((g.nx, g.ny, g.nz))) >= 2 else "rbsor"


def step_3d(g: Grid3D, fl: Fluid, dt: float, n_jacobi: int,
            state: State3D, phase: int,
            pressure_solver: str = "jacobi", sor_omega: float = 1.7,
            sor_tol: float = 1e-3, sor_max_iter: int = 200,
            csf: bool = False, sor_tol_rel: float = 0.0) -> State3D:
    """One step; ``phase`` = istep % 3 selects the sweep rotation
    (3dvof.py:351-363; the main loop pre-increments istep, so the first
    step runs phase 1). pressure_solver='rbsor'/'mg' swaps the
    reference-parity fixed Jacobi sweeps for a residual-driven upgrade
    (_rbsor_3d / ops.mg.mg_solve). ``csf=True`` enables 3-D surface
    tension (Youngs normals + Brackbill curvature, ops/normals3d.py) — an
    UPGRADE over the reference, whose 3-D normals kernel is commented out
    so kappa stays zero (3dvof.py:304-332,607); the default False keeps
    reference parity bit-for-bit. Phases run under `jax.named_scope`s
    (mix_normals, predict, bc, pressure, correct, fct_x/y/z) for trace
    attribution."""
    if pressure_solver == "auto":
        pressure_solver = _resolve_auto_3d(g)
    F, u, v, w, p = state
    with jax.named_scope("mix_normals"):
        rho, nu = mix_properties(fl, F)
        if csf:
            from .ops.normals3d import young_normals_curvature_3d

            _, _, _, kappa = young_normals_curvature_3d(g, F)
        else:
            # surface tension inert in 3-D, like the reference (3dvof.py:607)
            kappa = jnp.zeros_like(F)

    with jax.named_scope("predict"):
        u_star, v_star, w_star = predict_velocity_3d(
            g, fl, dt, u, v, w, F, rho, nu, kappa
        )
    with jax.named_scope("bc"):
        u, v, w, F, p, rho = apply_bc_3d(u, v, w, F, p, rho)
    with jax.named_scope("pressure"):
        if pressure_solver == "rbsor":
            rhs = _rhs_3d(g, dt, u_star, v_star, w_star, rho)
            p = _rbsor_3d(g, p, rhs, sor_omega, sor_tol, sor_max_iter,
                          tol_rel=sor_tol_rel)
        elif pressure_solver == "mg":
            from .ops.mg import mg_solve

            rhs = _rhs_3d(g, dt, u_star, v_star, w_star, rho)
            p = mg_solve(p, rhs, (g.dxi**2, g.dyi**2, g.dzi**2),
                         sor_tol, sor_max_iter, tol_rel=sor_tol_rel)
        elif pressure_solver != "jacobi":
            raise ValueError(
                f"unknown pressure_solver {pressure_solver!r} "
                "(expected 'jacobi', 'rbsor', or 'mg')")
        else:
            p = _solve_pressure_3d(g, dt, n_jacobi, p, u_star, v_star,
                                   w_star, rho)
    with jax.named_scope("correct"):
        u, v, w = update_velocity_3d(g, dt, u, v, w, u_star, v_star,
                                     w_star, p, rho)
    with jax.named_scope("bc"):
        u, v, w, F, p, rho = apply_bc_3d(u, v, w, F, p, rho)
    F = rudman_advect_3d(g, dt, F, u, v, w, phase)
    F = clamp01(F)
    with jax.named_scope("bc"):
        u, v, w, F, p, _ = apply_bc_3d(u, v, w, F, p, rho)
    return State3D(F=F, u=u, v=v, w=w, p=p)


def simulate_3d(g: Grid3D, state: State3D, n_steps: int,
                dt: float = 4e-6, n_jacobi: int = 10,
                fl: Fluid | None = None,
                istep0: int = 0, pressure_solver: str = "jacobi",
                sor_omega: float = 1.7, sor_tol: float = 1e-3,
                sor_max_iter: int = 200, csf: bool = False,
                sor_tol_rel: float = 0.0) -> State3D:
    """Advance n_steps with the reference's 1-based phase schedule
    (first step phase 1, then 2, 0, 1, ...) as one scanned program.

    ``istep0``: global index of the last step already taken — chunked
    callers (the CLI's frame loop) MUST pass it so the istep % 3 sweep
    rotation continues across calls exactly like the reference's
    continuous istep counter (3dvof.py:351-363); restarting the schedule
    each chunk follows a (valid but) different trajectory. Reduced mod 3
    before the jitted core, so chunked drivers compile at most three
    programs per shape."""
    g.validate()  # cubic cells only (the 3-D FCT scale factors assume it)
    if pressure_solver == "auto":
        pressure_solver = _resolve_auto_3d(g)
    return _simulate_3d_impl(g, state, n_steps, dt, n_jacobi, fl,
                             istep0 % 3, pressure_solver,
                             sor_omega, sor_tol, sor_max_iter, csf,
                             sor_tol_rel)


@partial(jax.jit,
         static_argnums=(0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12))
def _simulate_3d_impl(g: Grid3D, state: State3D, n_steps: int,
                      dt: float, n_jacobi: int,
                      fl: Fluid | None,
                      istep0: int, pressure_solver: str = "jacobi",
                      sor_omega: float = 1.7, sor_tol: float = 1e-3,
                      sor_max_iter: int = 200, csf: bool = False,
                      sor_tol_rel: float = 0.0) -> State3D:
    fl = fl or Fluid()

    def stepper(s, ph):
        return step_3d(g, fl, dt, n_jacobi, s, ph, pressure_solver,
                       sor_omega, sor_tol, sor_max_iter, csf, sor_tol_rel)

    ph1 = (istep0 + 1) % 3  # phase of the first step taken here

    def triple(s, _):
        s = stepper(s, ph1)
        s = stepper(s, (ph1 + 1) % 3)
        s = stepper(s, (ph1 + 2) % 3)
        return s, None

    n_triples, rem = divmod(n_steps, 3)
    state, _ = jax.lax.scan(triple, state, None, length=n_triples)
    for r in range(rem):
        state = stepper(state, (ph1 + r) % 3)
    return state
