"""Structured per-frame metrics and guards.

The reference's observability is `print` statements and an in-kernel Courant
warning (SURVEY.md §5): a startup banner (2dvof.py:95-99), per-frame
step/time lines (2dvof.py:533), and `if u*dt > 0.25*dx: print(...)` inside
`update_uv` (2dvof.py:274-280). Here the equivalents are device-computed
scalars gathered once per frame — liquid mass, max velocities, CFL numbers,
the divergence residual the fixed Jacobi solve leaves behind, and finiteness
guards — surfaced as a small pytree the driver can log or assert on.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import SimConfig
from .state import State

__all__ = ["Metrics", "compute_metrics", "banner"]


class Metrics(NamedTuple):
    mass: jnp.ndarray  # sum of F over the interior (liquid volume / dx*dy)
    max_u: jnp.ndarray
    max_v: jnp.ndarray
    cfl_u: jnp.ndarray  # max u*dt/dx — the reference warns when > 0.25
    cfl_v: jnp.ndarray
    max_div: jnp.ndarray  # max |div(u)| after projection (residual)
    finite: jnp.ndarray  # all fields finite?


def compute_metrics(cfg: SimConfig, state: State) -> Metrics:
    g, nm = cfg.grid, cfg.num
    F, u, v, p = state
    Fi = F[1:-1, 1:-1]
    max_u = jnp.max(jnp.abs(u))
    max_v = jnp.max(jnp.abs(v))
    div = (u[2:, 1:-1] - u[1:-1, 1:-1]) * g.dxi + (v[1:-1, 2:] - v[1:-1, 1:-1]) * g.dyi
    finite = (
        jnp.isfinite(F).all()
        & jnp.isfinite(u).all()
        & jnp.isfinite(v).all()
        & jnp.isfinite(p).all()
    )
    return Metrics(
        mass=jnp.sum(Fi),
        max_u=max_u,
        max_v=max_v,
        cfl_u=max_u * nm.dt * g.dxi,
        cfl_v=max_v * nm.dt * g.dyi,
        max_div=jnp.max(jnp.abs(div)),
        finite=finite,
    )


compute_metrics_jit = jax.jit(compute_metrics, static_argnums=(0,))


def banner(cfg: SimConfig) -> str:
    """Startup banner with the reference's derived ratios (2dvof.py:95-98)."""
    g, fl, nm = cfg.grid, cfg.fluid, cfg.num
    return (
        f">>> tpuvof: a two-phase VOF / Navier-Stokes solver in JAX.\n"
        f">>> Grid resolution: {g.nx} x {g.ny}, dt = {nm.dt:4.2e}\n"
        f">>> Density ratio: {fl.rho_l / fl.rho_g: 4.2f}, gravity: {fl.gy: 4.2f}, "
        f"sigma: {fl.sigma: 4.2f}\n"
        f">>> Viscosity ratio: {fl.nu_l / fl.nu_g: 4.2f}"
    )


def format_frame(istep: int, dt: float, m: Metrics, mode_name: str) -> str:
    """Per-frame log line (superset of the reference's 2dvof.py:533)."""
    warn = " [CFL>0.25!]" if float(m.cfl_u) > 0.25 or float(m.cfl_v) > 0.25 else ""
    nan = "" if bool(m.finite) else " [NON-FINITE!]"
    return (
        f">>> Number of steps:{istep:<5d}, Time:{istep * dt:5.2e} sec. "
        f"Displaying {mode_name}. mass={float(m.mass):.4f} "
        f"max|u|={float(m.max_u):.3e} max|v|={float(m.max_v):.3e} "
        f"CFL=({float(m.cfl_u):.3f},{float(m.cfl_v):.3f}) "
        f"div={float(m.max_div):.3e}{warn}{nan}"
    )
