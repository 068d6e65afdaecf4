"""Test configuration: force a virtual 8-device CPU mesh before JAX loads.

Multi-device sharding (tpuvof.parallel) is exercised on a host-platform
mesh per SURVEY.md §4: XLA_FLAGS=--xla_force_host_platform_device_count=8.
The platform is also pinned to cpu via jax.config after import, so a
machine with a GPU runs these tests on its CPU too (the GPU is exercised
by chip_smoke.py). float64 is enabled so golden trajectory comparisons
against the NumPy reference spec are not drowned in f32 rounding noise (ops
follow the dtype of their inputs; production runs stay float32).
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

# ---- fast/slow split (VERDICT r3 #6) ----
# The full suite takes ~50 minutes on the forced-CPU mesh; the heavy f64
# residual-driven solves, fuzz sweeps, and long goldens are marked `slow`
# (in the test files) and SKIPPED by default so the per-commit gate stays
# ~10 minutes. Run everything with `pytest tests/ --runslow` (CI and the
# round-close gate do).


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow (the full ~50-minute suite)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavy solve/fuzz/golden test, skipped unless "
        "--runslow (or RUNSLOW=1) is given")


# The slow set: the heavy f64 residual-driven solves, fuzz sweeps and long
# multi-device runs. The fast pool still covers every op (spec parity),
# both goldens, every distributed layout at a smaller size, the schedule
# contract, and the diff path — the slow set is the large-grid /
# many-step / fuzz-sweep redundancy on top. Central list (not per-file
# marks) so the policy lives in one place.
_SLOW = {
    "test_graft.py::test_dryrun_multichip_8",
    "test_graft.py::test_dryrun_multichip_odd",
    # implicit-adjoint heavies (round 5, measured 42 s / 31 s solo): the
    # fast set keeps the mechanism pins (direct FD + the 10^2 rollout FD
    # for both solvers); the 999-step bound and the 80^2 anchor are
    # horizon/size redundancy
    "test_diff_implicit.py::test_diff_mg_grads_bounded_999_steps",
    "test_diff_implicit.py::test_diff_mg_grad_at_80",
    # distributed mg (test_mg_dist.py, measured 45-150 s contended): the
    # fast set keeps the (2,4) 2-D solve at all three crossover regimes,
    # one 3-D solve, the 2-D full-step pin, and the raise test — the
    # layout sweep / 3-D redundancy / tolrel variant run under --runslow
    "test_mg_dist.py::test_solve_matches_serial_2d[8-1-0]",
    "test_mg_dist.py::test_solve_matches_serial_2d[8-1-256]",
    "test_mg_dist.py::test_solve_matches_serial_2d[8-1-1000000000]",
    "test_mg_dist.py::test_solve_matches_serial_2d[1-8-0]",
    "test_mg_dist.py::test_solve_matches_serial_2d[1-8-256]",
    "test_mg_dist.py::test_solve_matches_serial_2d[1-8-1000000000]",
    "test_mg_dist.py::test_solve_matches_serial_2d[2-2-0]",
    "test_mg_dist.py::test_solve_matches_serial_2d[2-2-256]",
    "test_mg_dist.py::test_solve_matches_serial_2d[2-2-1000000000]",
    "test_mg_dist.py::test_solve_matches_serial_3d[2-4-256]",
    "test_mg_dist.py::test_solve_matches_serial_3d[2-4-1000000000]",
    "test_mg_dist.py::test_solve_matches_serial_3d[4-1-0]",
    "test_mg_dist.py::test_solve_matches_serial_3d[4-1-256]",
    "test_mg_dist.py::test_solve_matches_serial_3d[4-1-1000000000]",
    "test_mg_dist.py::test_solve_matches_serial_tolrel",
    "test_mg_dist.py::test_step_dist3d_mg_matches_serial",
    "test_parallel_3d.py::test_distributed_3d_pencil_from_non_bc_consistent_state",
    "test_csf3d.py::test_sigma_zero_bit_parity_and_default_off",
    "test_parallel_3d.py::test_distributed_3d_pencil_fuzz[0]",
    "test_parallel_3d.py::test_distributed_3d_pencil_fuzz[1]",
    "test_diff.py::test_selfadjoint_adjoint_close_to_unrolled",
    "test_parallel_3d.py::test_distributed_3d_csf_matches_serial[2]",
    "test_schedule.py::test_distributed_istep0_continues_schedule",
    "test_parallel_3d.py::test_distributed_3d_rbsor_matches_serial",
    "test_mg.py::test_step_integration_3d",
    "test_parallel_3d.py::test_distributed_3d_csf_matches_serial[4]",
    "test_parallel_3d.py::test_distributed_3d_two_axis_matches_serial[2-2-5]",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        name = item.nodeid.split("/")[-1]
        if name in _SLOW:
            item.add_marker(pytest.mark.slow)
    if config.getoption("--runslow") or os.environ.get("RUNSLOW"):
        return
    skip = pytest.mark.skip(reason="slow: use --runslow for the full suite")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
