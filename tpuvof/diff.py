"""Differentiable simulation (layer L5): optimize the initial volume
fraction F0 so the end state of the full solver matches a target shape.

Re-design of the reference's time-unrolled Taichi autodiff programs:

- diff_vof.py keeps every field with an explicit time axis (F gets 2T+1
  slices, p stores every Jacobi iterate: T*(K+1) slices — diff_vof.py:57-61)
  and replays kernels in reverse under ti.ad.Tape. Here the same
  computation is `jax.grad` through a `lax.scan` whose body is wrapped in
  `jax.checkpoint`: memory is O(T) small carries + one step's
  rematerialized intermediates, with no time-unrolled fields at all.
- diff_vof_replaced.py's hand-written pressure adjoint (grad_replaced /
  grad_for, :303-330) is Numerics.pressure_adjoint='selfadjoint' — the
  custom_vjp in ops/poisson.py — which drops even the rematerialized
  Jacobi chain from the backward pass.

Differences from the forward solver replicated exactly (diff_vof.py:485-522):
0-based sweep parity (first step sweeps y then x), the diff FCT variant
(flux-only dV, no in-sweep clamping, limiter guard eps=1e-6), interior-only
final clamp, and the deliberately skipped mid-step BC applications (walls
hold zero velocity either way; comments at diff_vof.py:500-517).

The optimization loop matches diff_vof.py:569-575: L1 loss over the full
padded array (compute_loss, :471-474), SGD on interior F0 with the |g| < 5
gradient gate and re-clamp (apply_grad, :477-482).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .config import SimConfig, Fluid, Numerics, FCT_DIFF
from .grid import Grid2D
from .state import State, find_area
from .ops import (
    clamp01,
    apply_bc,
    mix_properties,
    predict_velocity,
    rudman_advect,
    solve_pressure,
    update_velocity,
    young_normals_curvature,
)

__all__ = [
    "DiffOptions",
    "diff_config",
    "diff_target",
    "paint_blocks",
    "step_diff",
    "rollout",
    "l1_loss",
    "loss_and_grad",
    "apply_grad",
    "optimize_f0",
    "optimize_advection_f0",
]


@dataclass(frozen=True)
class DiffOptions:
    """Optimization hyperparameters (reference diff_vof.py:36-39,477-482)."""

    n_steps: int = 999  # MAX_TIME_STEPS - 1 forward steps per epoch
    lr: float = 0.02
    grad_gate: float = 5.0  # skip updates where |dL/dF0| >= gate
    remat: bool = True  # checkpoint each step in the scan


def diff_config(n: int = 80, n_jacobi: int = 10,
                adjoint: str = "selfadjoint",
                pressure_solver: str = "jacobi", sor_tol: float = 1e-3,
                sor_max_iter: int = 200,
                sor_tol_rel: float = 0.0) -> SimConfig:
    """The differentiable workload config (diff_vof.py:19-39): 80x80,
    gy = -1000, diff FCT variant.

    adjoint defaults to 'selfadjoint' (the diff_vof_replaced.py pressure
    adjoint, which there uses 20 iterations): besides skipping the
    rematerialized Jacobi chain in the backward pass, it is the numerically
    robust choice — XLA's auto-transposed Jacobi backward is stable on CPU
    but is not guaranteed to be on an accelerator backend, where it has
    been seen to grow geometrically with the horizon (~x1.13/step), which
    freezes the gated SGD. The hand-written adjoint stays bounded (~4) at
    every horizon. 'unrolled' remains available for exact
    finite-difference gradient checks on CPU.

    pressure_solver upgrades the projection inside the differentiable
    step too (VERDICT r4 #4): under 'selfadjoint', 'rbsor'/'mg' run the
    implicit-function adjoint — one more CONVERGED solve on the projected
    cotangent (ops/mg.mg_solve_implicit) — so the production converged
    projection is usable under jax.grad; 'unrolled' supports 'jacobi'
    only (the residual while_loops cannot unroll)."""
    if pressure_solver != "jacobi" and adjoint != "selfadjoint":
        raise ValueError(
            f"pressure_solver={pressure_solver!r} is differentiable only "
            "under pressure_adjoint='selfadjoint' (the implicit-function "
            "adjoint); 'unrolled' cannot differentiate a while_loop")
    return SimConfig(
        grid=Grid2D(n, n),
        fluid=Fluid(gy=-1000.0),
        num=Numerics(
            dt=4e-6, n_jacobi=n_jacobi, fct=FCT_DIFF,
            pressure_adjoint=adjoint, pressure_solver=pressure_solver,
            sor_tol=sor_tol, sor_max_iter=sor_max_iter,
            sor_tol_rel=sor_tol_rel,
        ),
    )


def diff_target(cfg: SimConfig, ic: int) -> jnp.ndarray:
    """Programmatic targets of the reference's diff set_init_F
    (diff_vof.py:152-176): 1 = centered block, 2 = circle at the domain
    center, 3 = inverse circle."""
    g = cfg.grid
    if ic == 1:
        xn = g.node_x()[:, None]
        yn = g.node_y()[None, :]
        cond = (
            (xn >= g.Lx / 3) & (xn <= 2 * g.Lx / 3) & (yn >= 0.0) & (yn <= g.Ly / 2)
        )
        return jnp.asarray(np.where(cond, np.float32(1.0), np.float32(0.0)))
    if ic == 2:
        return jnp.asarray(find_area(g, g.Lx / 2, g.Ly / 2, g.Lx / 12))
    if ic == 3:
        return jnp.asarray(1.0 - find_area(g, g.Lx / 2, g.Ly / 2, g.Lx / 12))
    raise ValueError(f"unknown target ic {ic}")


def paint_blocks(g: Grid2D, points, target=None) -> jnp.ndarray:
    """File/programmatic replacement for the paint-a-target UI
    (diff_vof.py:179-198): each (x, y) in [0,1]^2 stamps a 4x4 block of 1s,
    exactly like the reference's set_pixel kernel."""
    t = np.zeros(g.shape, np.float32) if target is None else np.asarray(target).copy()
    for x, y in points:
        xc = int(x * g.nx)
        yc = int(y * g.ny)
        for i in range(max(0, xc - 2), xc + 2):
            for j in range(max(0, yc - 2), yc + 2):
                if i < t.shape[0] and j < t.shape[1]:
                    t[i, j] = 1.0
    return jnp.asarray(t)


def step_diff(cfg: SimConfig, state: State, even_step: bool) -> State:
    """One differentiable step (diff_vof.py forward(), :485-522): like the
    forward solver but without the two mid-step BC re-applications and with
    an interior-only final clamp."""
    g, fl, nm = cfg.grid, cfg.fluid, cfg.num
    F, u, v, p = state

    rho, nu = mix_properties(fl, F)
    _, _, kappa = young_normals_curvature(g, F)
    u_star, v_star = predict_velocity(g, fl, nm, u, v, F, rho, nu, kappa)
    p = solve_pressure(g, nm, p, u_star, v_star, rho)
    u, v = update_velocity(g, nm, u, v, u_star, v_star, p, rho)
    F = rudman_advect(g, nm, F, u, v, even_step)
    F = F.at[1:-1, 1:-1].set(clamp01(F[1:-1, 1:-1]))
    u, v, F, p, rho = apply_bc(u, v, F, p, rho)
    return State(F=F, u=u, v=v, p=p)


def rollout(cfg: SimConfig, F0, n_steps: int, remat: bool = True) -> State:
    """n_steps of step_diff from a zero-velocity start, 0-based parity
    (step 0 sweeps y then x — diff_vof.py:345-351)."""
    z = jnp.zeros_like(F0)
    state = State(F=F0, u=z, v=z, p=z)

    def pair_body(s, _):
        s = step_diff(cfg, s, even_step=True)
        s = step_diff(cfg, s, even_step=False)
        return s, None

    body = jax.checkpoint(pair_body) if remat else pair_body
    n_pairs, rem = divmod(n_steps, 2)
    state, _ = jax.lax.scan(body, state, None, length=n_pairs)
    if rem:
        state = step_diff(cfg, state, even_step=True)
    return state


@partial(jax.jit, static_argnums=(0, 2, 3))
def _rollout_chunk(cfg: SimConfig, state: State, k: int,
                   parity0: int) -> State:
    """k steps of step_diff continuing the 0-based parity schedule from
    global step index parity0 (chunked calls MUST pass it — cf. the
    istep0 contract of solver.simulate)."""
    first_even = parity0 == 0

    def pair_body(s, _):
        s = step_diff(cfg, s, even_step=first_even)
        s = step_diff(cfg, s, even_step=not first_even)
        return s, None

    n_pairs, rem = divmod(k, 2)
    state, _ = jax.lax.scan(pair_body, state, None, length=n_pairs)
    if rem:
        state = step_diff(cfg, state, even_step=first_even)
    return state


def rollout_frames(cfg: SimConfig, F0, n_steps: int, every: int):
    """Visualization-only chunked forward: the reference renders
    current-vs-target every 20 steps INSIDE each optimization forward
    (diff_vof.py:524-554); this generator yields (step, F) every `every`
    steps of the same trajectory so the CLI can write those frames. Same
    0-based parity schedule as `rollout` (chunking preserves it via the
    step-index parity); the final state is bit-identical to
    rollout(remat=False) — pinned by tests/test_diff.py. No remat, no
    grad: the gradient path is untouched."""
    z = jnp.zeros_like(F0)
    state = State(F=F0, u=z, v=z, p=z)
    done = 0
    while done < n_steps:
        k = min(every, n_steps - done)
        state = _rollout_chunk(cfg, state, k, done % 2)
        done += k
        yield done, state.F


def l1_loss(F_final, Ftarget):
    """L1 over the full padded array, ghosts included (diff_vof.py:471-474)."""
    return jnp.sum(jnp.abs(Ftarget - F_final))


@partial(jax.jit, static_argnums=(0, 3, 4))
def loss_and_grad(cfg: SimConfig, F0, Ftarget, n_steps: int, remat: bool = True):
    def loss_fn(F0):
        state = rollout(cfg, F0, n_steps, remat=remat)
        return l1_loss(state.F, Ftarget)

    return jax.value_and_grad(loss_fn)(F0)


@partial(jax.jit, static_argnums=(3, 4))
def apply_grad(F0, grad, lr=0.02, grad_gate: float = 5.0, interior_only: bool = True):
    """Gated SGD + clamp (diff_vof.py:477-482): update only where
    |grad| < gate, clamp updated entries to [0, 1]."""
    # gate=None disables gating; gate=0.0 means the literal |g| < 0
    # (update nothing) — a falsy test here silently inverted that
    ok = (jnp.abs(grad) < grad_gate if grad_gate is not None
          else jnp.ones_like(grad, bool))
    new = jnp.clip(F0 - lr * grad, 0.0, 1.0)
    upd = jnp.where(ok, new, F0)
    if interior_only:
        return F0.at[1:-1, 1:-1].set(upd[1:-1, 1:-1])
    return upd


def optimize_f0(
    cfg: SimConfig,
    Ftarget,
    F0=None,
    opts: DiffOptions = DiffOptions(),
    n_epochs: int = 100,
    callback=None,
):
    """The full optimization cycle (diff_vof.py:569-575). Returns
    (F0, losses)."""
    if F0 is None:
        F0 = jnp.zeros(cfg.grid.shape, jnp.float32)
    losses = []
    for epoch in range(n_epochs):
        loss, grad = loss_and_grad(cfg, F0, Ftarget, opts.n_steps, opts.remat)
        F0 = apply_grad(F0, grad, opts.lr, opts.grad_gate)
        losses.append(float(loss))
        if callback is not None:
            callback(epoch, float(loss), F0, grad)
    return F0, losses


# ----------------------------------------------------------------------
# Differentiable pure advection (test/diff_fct.py): gradient-check the FCT
# kernels alone under a fixed velocity field.
# ----------------------------------------------------------------------
def advection_loss_and_grad(case, F0, u, v, Ftarget, n_steps: int):
    """Loss = L1 over cells [imin, imax+1] x [jmin, jmax+1]
    (test/diff_fct.py:378-381) after n advection steps."""
    from .models.advection import simulate_advection

    def loss_fn(F0):
        F = simulate_advection(case, F0, u, v, n_steps)
        return jnp.sum(jnp.abs(Ftarget[1:, 1:] - F[1:, 1:]))

    return jax.value_and_grad(loss_fn)(F0)


def optimize_advection_f0(case, u, v, Ftarget, n_steps: int, n_epochs: int,
                          lr: float = 0.1, F0=None):
    """test/diff_fct.py's cycle: from all-ones F0 (:111-112), plain SGD with
    clamp and no gradient gate (:384-389)."""
    if F0 is None:
        F0 = jnp.ones(case.grid.shape, jnp.float32)
    losses = []
    lag = jax.jit(advection_loss_and_grad, static_argnums=(0, 5))
    for _ in range(n_epochs):
        loss, grad = lag(case, F0, u, v, Ftarget, n_steps)
        F0 = jnp.clip(F0 - lr * grad, 0.0, 1.0)
        losses.append(float(loss))
    return F0, losses
