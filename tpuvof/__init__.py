"""tpuvof: a two-phase incompressible Navier-Stokes / VOF framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of the reference
Taichi solver (houkensjtu/taichi-2d-vof): staggered MAC grid,
Rudman/Zalesak flux-corrected VOF transport, Brackbill CSF surface tension
with Youngs normals, Chorin projection with fixed-iteration Jacobi,
canonical initial conditions, five visualization modes with PNG/video
export, a differentiable-simulation path (optimize F0 through the full
solver), an experimental 3-D extension with VTK export — plus extras the
reference lacks: one jitted step under `lax.scan`, `shard_map` domain
decomposition with `ppermute` halo exchange, multigrid and red-black SOR
pressure solvers, checkpoints/resume and structured metrics. It runs on
one GPU or a mesh of them; the tests run on the CPU.
"""

from .grid import Grid2D, Grid3D
from .config import (
    Fluid,
    FCTVariant,
    Numerics,
    SimConfig,
    FCT_FORWARD,
    FCT_DIFF,
    FCT_SCHEME_TEST,
    dam_break_2d,
)
from .state import (
    State,
    State3D,
    init_state,
    init_state_3d,
    initial_volume_fraction,
    find_area,
)
from .solver import (step, step_pair, simulate, simulate_cfl,
                     make_step_fn)
from .solver3d import step_3d, simulate_3d

__version__ = "0.1.0"
