"""Simulation configuration.

The reference keeps all physics/numerics as module-level constants
(2dvof.py:19-34) plus exactly two CLI flags (2dvof.py:11-17). Here the whole
configuration is a frozen, hashable dataclass tree so it can ride through
`jax.jit` as a static argument and select compile-time-specialized code paths
(fixed Jacobi trip counts, FCT variant, sweep schedules).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from .grid import Grid2D

__all__ = [
    "Fluid",
    "FCTVariant",
    "Numerics",
    "SimConfig",
    "FCT_FORWARD",
    "FCT_DIFF",
    "FCT_SCHEME_TEST",
    "dam_break_2d",
]


@dataclass(frozen=True)
class Fluid:
    """Two-phase fluid properties (reference 2dvof.py:24-31)."""

    rho_l: float = 1000.0
    rho_g: float = 50.0
    nu_l: float = 1.0e-6  # kinematic viscosity of the liquid
    nu_g: float = 1.5e-5
    sigma: float = 0.007  # surface tension coefficient
    gx: float = 0.0
    gy: float = -5.0
    gz: float = 0.0


@dataclass(frozen=True)
class FCTVariant:
    """Flux-corrected-transport behavioral variant.

    The reference has three subtly different FCT implementations
    (SURVEY.md §2.5.2-3); this dataclass captures all of their knobs:

    - ``full_dv``: apply the divergence-compensation factor dV/dv to
      (F + flux) as in the main solver (2dvof.py:329) vs. to the flux term
      only as in the differentiable/test variants (diff_vof.py:360,
      test/forward_fct.py:273).
    - ``clamp``: clamp Ftd and the corrected F to [0,1] inside the sweep
      (2dvof.py:330-331,382); the diff/test variants do not.
    - ``guard_eps``: limiter fires only when pp > guard_eps
      (2dvof.py:354 uses 0; diff_vof.py:373 uses 1e-6).
    - ``denom_eps``: added to the limiter denominator, qp / (pp + denom_eps)
      (test/forward_fct.py:287 uses the eps argument; others use 0).
    """

    full_dv: bool = True
    clamp: bool = True
    guard_eps: float = 0.0
    denom_eps: float = 0.0


FCT_FORWARD = FCTVariant(full_dv=True, clamp=True, guard_eps=0.0, denom_eps=0.0)
FCT_DIFF = FCTVariant(full_dv=False, clamp=False, guard_eps=1e-6, denom_eps=0.0)
FCT_SCHEME_TEST = FCTVariant(full_dv=False, clamp=False, guard_eps=0.0, denom_eps=1e-4)


@dataclass(frozen=True)
class Numerics:
    """Time stepping and solver controls."""

    dt: float = 4e-6  # reference 2dvof.py:33
    n_jacobi: int = 10  # fixed iteration count, no residual check (2dvof.py:521)
    fct: FCTVariant = field(default_factory=FCTVariant)
    # test/forward_fct.py:258-265 mirrors F ghosts between the two half
    # sweeps; the main solver does not.
    bc_between_sweeps: bool = False
    # 'unrolled' differentiates straight through the Jacobi iterations
    # (diff_vof.py semantics); 'selfadjoint' installs the hand-written
    # adjoint mirroring diff_vof_replaced.py:303-330.
    pressure_adjoint: str = "unrolled"
    # 'jacobi' = the reference's fixed-iteration sweep; 'rbsor' = red-black
    # SOR iterated to an on-device residual tolerance; 'mg' = residual-
    # driven geometric-multigrid V-cycles (ops/mg.py — O(1) cycles in grid
    # size where rbsor needs O(n) sweeps; serial AND distributed via
    # parallel/mg.py); 'auto' = mg wherever the global grid coarsens (all
    # extents even and >= 8), rbsor otherwise — serial and distributed
    # alike (resolution sites: solver.resolve_auto, solver3d,
    # Decomp/Decomp3D). Under pressure_adjoint='selfadjoint' both
    # residual-driven solvers are differentiable via the implicit-
    # function adjoint (ops/mg.mg_solve_implicit, ops/poisson.
    # _rbsor_implicit); 'unrolled' supports 'jacobi' only.
    # sor_tol/sor_max_iter govern both residual-driven solvers (max_iter
    # counts V-cycles under 'mg'); sor_omega is rbsor-only (the MG
    # smoother is plain red-black Gauss-Seidel).
    pressure_solver: str = "jacobi"
    sor_omega: float = 1.7
    sor_tol: float = 1e-3
    sor_max_iter: int = 200
    # Relative stopping tolerance for the residual-driven solvers: when
    # > 0, each solve stops at max(sor_tol, sor_tol_rel * max|rhs'|)
    # where rhs' is that solve's nullspace-projected right-hand side.
    # An ABSOLUTE sor_tol is unreachable for production-scale flows
    # (rhs ~ rho/dt * div(u*) reaches 1e8), so without this every step burns the
    # iteration cap / runs to the f32 floor. sor_tol_rel makes the
    # upgrade cost bounded and scale-invariant: the warm-started
    # per-step solve terminates after O(1) cycles/sweeps once the flow
    # is developed. 0.0 (default) preserves the absolute-only semantics
    # bit-for-bit (the tolerance stays a compile-time constant).
    sor_tol_rel: float = 0.0


@dataclass(frozen=True)
class SimConfig:
    """Full static simulation configuration (hashable; jit-static)."""

    grid: Grid2D = field(default_factory=lambda: Grid2D(200, 200))
    fluid: Fluid = field(default_factory=Fluid)
    num: Numerics = field(default_factory=Numerics)

    def __post_init__(self):
        # the FCT limiter scaling assumes square cells (fct.py docstring);
        # a non-square grid silently mis-scaled the y-sweep before this
        self.grid.validate()

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


def dam_break_2d(n: int = 200, **kw) -> SimConfig:
    """The reference's default 2-D workload (2dvof.py:19-34)."""
    return SimConfig(grid=Grid2D(n, n), **kw)
