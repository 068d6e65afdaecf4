"""Mesh planner (parallel/plan.py): divisibility, HBM footprint per shard
and halo surface per step decide the ranking of (px, py) meshes."""
import pytest

import tpuvof as tv
from tpuvof.grid import Grid3D
from tpuvof.parallel import format_plans, plan_mesh_2d, plan_mesh_3d
from tpuvof.parallel.plan import H100_BYTES, MIN_LOCAL, WORKSET


def _cfg(n, n_jacobi=10):
    return tv.SimConfig(grid=tv.Grid2D(n, n),
                        num=tv.Numerics(n_jacobi=n_jacobi))


def test_plan_2d_single_device_has_no_halo():
    (plan,) = plan_mesh_2d(_cfg(512), 1)
    assert plan.mesh_shape == (1, 1) and plan.layout == "single"
    assert plan.halo_mb_step == 0.0 and plan.fits
    assert plan.hbm_mb == pytest.approx(
        4 * 514 * 514 * 4 * WORKSET / 2**20, rel=1e-3)


def test_plan_2d_square_blocks_win_at_16_devices():
    """At 16 devices a 4x4 block ships 4 lines of 130 per exchange, a
    16x1 slab 2 lines of 514: blocks have the smaller surface."""
    plans = plan_mesh_2d(_cfg(512), 16)
    assert plans[0].mesh_shape == (4, 4)
    by = {p.mesh_shape: p for p in plans}
    assert by[(4, 4)].halo_mb_step < by[(16, 1)].halo_mb_step
    assert by[(16, 1)].halo_mb_step == by[(1, 16)].halo_mb_step


def test_plan_2d_halo_scales_with_jacobi_sweeps():
    """The pressure solve exchanges p once per sweep: more sweeps, more
    bytes per step, same ranking."""
    few = {p.mesh_shape: p for p in plan_mesh_2d(_cfg(512, 2), 4)}
    many = {p.mesh_shape: p for p in plan_mesh_2d(_cfg(512, 40), 4)}
    for shape in few:
        assert many[shape].halo_mb_step > few[shape].halo_mb_step


def test_plan_skips_indivisible_and_too_thin_meshes():
    # 12 does not split 8 ways; 3 ways x 4 cells is the thinnest allowed
    shapes = {p.mesh_shape for p in plan_mesh_2d(_cfg(12), 8)}
    assert shapes == {(2, 4), (4, 2)}
    assert MIN_LOCAL == 3
    thin = {p.mesh_shape for p in plan_mesh_2d(_cfg(8), 4)}
    assert (4, 1) not in thin and (2, 2) in thin  # 8/4 = 2 < MIN_LOCAL


def test_plan_marks_shards_beyond_device_memory():
    """A state larger than one H100's 80 GiB is ranked last and marked:
    32768^2 needs ~104 GiB as one shard, ~52 GiB per card over 2."""
    (one,) = plan_mesh_2d(_cfg(32768), 1)
    assert not one.fits and one.hbm_mb > H100_BYTES / 2**20
    assert "no" in format_plans([one]).splitlines()[1]
    assert all(p.fits for p in plan_mesh_2d(_cfg(32768), 2))
    assert all(p.fits for p in plan_mesh_2d(_cfg(32768), 8))


def test_plan_3d_slab_when_it_fits():
    """200^3 on 4 cards: x slabs and 2x2 pencils move nearly the same
    plane surface; slabs move slightly less in half the collectives, and
    timed faster on four H100s. On 2 cards the x slab wins the tie."""
    four = plan_mesh_3d(Grid3D(200, 200, 200), 4)
    assert four[0].mesh_shape == (4, 1) and four[0].layout == "x-slabs"
    by4 = {p.mesh_shape: p for p in four}
    assert by4[(2, 2)].layout == "pencils"
    assert by4[(4, 1)].halo_mb_step < by4[(2, 2)].halo_mb_step
    two = plan_mesh_3d(Grid3D(200, 200, 200), 2)
    assert two[0].mesh_shape == (2, 1) and two[0].layout == "x-slabs"


def test_plan_3d_flagship_8_chips_prefers_pencil():
    """200^3 on 8 cards: a 4x2 pencil ships less than an 8x1 slab."""
    plans = plan_mesh_3d(Grid3D(200, 200, 200), 8)
    assert plans[0].mesh_shape == (4, 2) and plans[0].layout == "pencils"
    by = {p.mesh_shape: p for p in plans}
    assert by[(4, 2)].halo_mb_step < by[(8, 1)].halo_mb_step


def test_plan_3d_agrees_with_decomp3d_admission():
    """Every ranked shape is one Decomp3D accepts (8 virtual devices)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from tpuvof.parallel import Decomp3D

    g = Grid3D(24, 24, 24)
    plans = plan_mesh_3d(g, 8)
    assert {p.mesh_shape for p in plans} == {(1, 8), (2, 4), (4, 2),
                                             (8, 1)}
    devs = np.array(jax.devices()[:8])
    for p in plans:
        mesh = (Mesh(devs, ("mx",)) if p.py == 1
                else Mesh(devs.reshape(p.px, p.py), ("mx", "my")))
        dec = Decomp3D(g, mesh)
        assert (dec.nxl, dec.nyl) == (24 // p.px, 24 // p.py)


def test_admission_table_512_cube():
    """512^3: 5 f32 fields are 2.7 GB with ghosts; times WORKSET the one-
    card plan needs ~17.6 GB and fits an 80 GiB H100. 1024^3 needs
    ~140 GB on one card and fits on 2 or more."""
    (one,) = plan_mesh_3d(Grid3D(512, 512, 512), 1)
    assert one.fits and one.hbm_mb == pytest.approx(
        5 * 514**3 * 4 * WORKSET / 2**20, rel=1e-3)
    big = Grid3D(1024, 1024, 1024)
    (single,) = plan_mesh_3d(big, 1)
    assert not single.fits
    assert all(p.fits for p in plan_mesh_3d(big, 2))
    assert all(p.fits for p in plan_mesh_3d(big, 4))


def test_plan_formatting_and_no_fit():
    out = format_plans(plan_mesh_3d(Grid3D(64, 64, 64), 4))
    assert "mesh" in out and "x-slabs" in out and "halo MB/step" in out
    assert "no mesh shape" in format_plans(plan_mesh_2d(_cfg(7), 4))
