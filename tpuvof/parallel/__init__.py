"""Scale-out layer: device meshes, halo exchange, distributed stepping.

The reference is single-device (SURVEY.md §2: no parallelism strategies, no
communication backend). This package adds spatial domain decomposition over
a `jax.sharding.Mesh` with `shard_map`, ghost cells filled by `ppermute`
halo exchanges between neighbouring devices.
"""
from .halo import HaloSpec, exchange
from .dist import Decomp
from .dist3d import Decomp3D
from .mesh import make_mesh
from .plan import MeshPlan, format_plans, plan_mesh_2d, plan_mesh_3d

__all__ = ["HaloSpec", "exchange", "Decomp", "Decomp3D", "make_mesh",
           "MeshPlan", "plan_mesh_2d",
           "plan_mesh_3d", "format_plans"]
