"""Mesh planning: rank (px, py) decompositions for a grid + device count.

The scaling-book recipe is "pick a mesh, annotate shardings, let XLA
insert collectives" — this module automates the FIRST step for Decomp
(2-D) and Decomp3D (3-D). Every device reaches every other at the same
rate (GPUs joined all to all), so the mesh follows the algorithm alone and
a shape is judged by what one shard pays:

  divisibility   the grid must split evenly, and every sharded axis must
                 keep at least MIN_LOCAL cells per shard (the FCT sweep's
                 wide halo comes from ONE neighbour);
  HBM footprint  the shard's state fields (ghost ring included) times
                 WORKSET, the measured ratio of a step's peak device
                 memory to its state; a shard that exceeds the device's
                 memory is ranked last and marked as not fitting;
  halo surface   bytes the exchanges move per step: each sharded axis
                 costs two ppermutes (one per direction, parallel/halo.py),
                 each moving one ghost line (2-D) or plane (3-D) per pair
                 of shards. A ppermute's time follows the size of what one
                 pair moves, not how many pairs take part, so the surface
                 is 2 lines per sharded axis — even where the axis is
                 split in two and each shard has one neighbour on it —
                 times the number of exchanges a Jacobi step makes.

At a fixed device count the owned work per shard is the same for every
shape, so plans that fit are ranked by halo bytes per step, then by fewer
sharded axes (fewer collectives per exchange), then by splitting x. At
200^3 on four H100s x slabs timed 2.58 ms/step against 2.70 for 2x2
pencils (PERF.md), the order this ranking gives. Pure shape math — no
jax.Device needed (CLI: `python -m tpuvof --plan-mesh N [--three-d]`).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..config import SimConfig
from ..grid import Grid3D

__all__ = ["MeshPlan", "plan_mesh_2d", "plan_mesh_3d", "format_plans"]

# Each sharded axis keeps at least this many cells per shard: the FCT
# sweeps widen F and the velocity by 2 lines from the neighbour's owned
# cells, plus the ghost line.
MIN_LOCAL = 3
# Peak device memory of a jitted run over its state bytes (f32 XLA path):
# 1.08 GB peak for the 165 MB state of 200^3 Jacobi on an H100 (PERF.md).
WORKSET = 6.5
H100_BYTES = 80 * 2**30
_F32 = 4


@dataclass(frozen=True)
class MeshPlan:
    """One ranked decomposition candidate."""

    px: int
    py: int
    layout: str          # 'single' | 'x-slabs' | 'y-slabs' | 'blocks'/'pencils'
    hbm_mb: float        # state per shard x WORKSET, MB
    halo_mb_step: float  # bytes the exchanges move per step, MB
    fits: bool           # hbm_mb within one H100's memory
    detail: str          # local extents

    @property
    def mesh_shape(self) -> tuple[int, int]:
        return (self.px, self.py)


def _divisor_pairs(n: int):
    for px in range(1, n + 1):
        if n % px == 0:
            yield px, n // px


def _layout(px: int, py: int, three_d: bool) -> str:
    if px == py == 1:
        return "single"
    if py == 1:
        return "x-slabs"
    if px == 1:
        return "y-slabs"
    return "pencils" if three_d else "blocks"


def _rank(plans: list[MeshPlan]) -> list[MeshPlan]:
    # ties go to fewer sharded axes, then to splitting x (Decomp3D's
    # slab axis: its y/z sweeps stay local)
    return sorted(plans, key=lambda p: (not p.fits, p.halo_mb_step,
                                        (p.px > 1) + (p.py > 1), p.py))


def plan_mesh_2d(cfg: SimConfig, n_devices: int) -> list[MeshPlan]:
    """Ranked (px, py) meshes for the 2-D solver (Decomp).

    Exchanges per Jacobi step (parallel/dist.py): mx, my, kappa; u*, v*;
    p once per Jacobi sweep; 5 fields at each of the 3 BC passes; Ftd,
    rp, rm per FCT sweep and F between the sweeps."""
    g = cfg.grid
    n_exch = 3 + 2 + cfg.num.n_jacobi + 15 + 6 + 1
    plans = []
    for px, py in _divisor_pairs(n_devices):
        if g.nx % px or g.ny % py:
            continue
        nxl, nyl = g.nx // px, g.ny // py
        if (px > 1 and nxl < MIN_LOCAL) or (py > 1 and nyl < MIN_LOCAL):
            continue
        state = 4 * (nxl + 2) * (nyl + 2) * _F32
        lines = (2 * (nyl + 2) if px > 1 else 0) \
            + (2 * (nxl + 2) if py > 1 else 0)
        hbm = state * WORKSET
        plans.append(MeshPlan(
            px, py, _layout(px, py, False), round(hbm / 2**20, 3),
            round(n_exch * lines * _F32 / 2**20, 4), hbm <= H100_BYTES,
            f"shard {nxl}x{nyl}"))
    return _rank(plans)


def plan_mesh_3d(g: Grid3D, n_devices: int,
                 n_jacobi: int = 10) -> list[MeshPlan]:
    """Ranked (px, py) meshes for the 3-D solver (Decomp3D): x slabs
    (py=1) and (x,y) pencils; z is never decomposed.

    Exchanges per Jacobi step (parallel/dist3d.py): u*, v*, w*; p once
    per Jacobi sweep; 5 fields at each of the 3 BC passes; F after each
    of the 3 FCT sweeps; 2 fields x 2 planes for the widened sweep along
    each sharded axis."""
    plans = []
    for px, py in _divisor_pairs(n_devices):
        if g.nx % px or g.ny % py:
            continue
        nxl, nyl = g.nx // px, g.ny // py
        if (px > 1 and nxl < MIN_LOCAL) or (py > 1 and nyl < MIN_LOCAL):
            continue
        n_exch = 3 + n_jacobi + 15 + 3 + 4
        state = 5 * (nxl + 2) * (nyl + 2) * (g.nz + 2) * _F32
        planes = (2 * (nyl + 2) if px > 1 else 0) \
            + (2 * (nxl + 2) if py > 1 else 0)
        hbm = state * WORKSET
        plans.append(MeshPlan(
            px, py, _layout(px, py, True), round(hbm / 2**20, 3),
            round(n_exch * planes * (g.nz + 2) * _F32 / 2**20, 4),
            hbm <= H100_BYTES, f"shard {nxl}x{nyl}x{g.nz}"))
    return _rank(plans)


def format_plans(plans: list[MeshPlan]) -> str:
    """Human-readable ranking table (CLI --plan-mesh)."""
    if not plans:
        return "no mesh shape divides this grid at that device count"
    lines = [f"{'mesh':>8}  {'layout':<8} {'HBM MB':>10} "
             f"{'halo MB/step':>12} {'fits':>5}  detail"]
    for p in plans:
        lines.append(f"{p.px:>3}x{p.py:<4}  {p.layout:<8} {p.hbm_mb:>10} "
                     f"{p.halo_mb_step:>12} {'yes' if p.fits else 'no':>5}"
                     f"  {p.detail}")
    return "\n".join(lines)
