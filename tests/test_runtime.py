"""Run-time setup (utils/runtime.py), the CLI surface that stays, and the
trace reduction (utils/profiling.py)."""
import os
import subprocess
import sys

import pytest

from tpuvof import cli
from tpuvof.utils import profiling
from tpuvof.utils.runtime import CHECKOUT, compile_cache_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_dir_fixed_in_checkout():
    assert CHECKOUT == ROOT
    path = compile_cache_dir({})
    assert path == os.path.join(ROOT, ".jax_cache")
    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == path


def test_compile_cache_dir_defers_to_env():
    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x"}) is None


def test_jax_cache_is_git_ignored():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_enable_compile_cache_in_a_fresh_process(env_dir, tmp_path):
    """What JAX ends up using: the env var's directory when set (nothing is
    set in code), the fixed checkout path otherwise."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = ("import jax; from tpuvof.utils.runtime import "
            "enable_compile_cache as e; r = e(); "
            "print(r); print(jax.config.jax_compilation_cache_dir)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    returned, used = r.stdout.split()[-2:]
    want = (str(tmp_path / env_dir) if env_dir
            else os.path.join(ROOT, ".jax_cache"))
    assert returned == used == want


def test_backend_option_is_gone():
    p = cli.build_parser()
    assert "--backend" not in p._option_string_actions
    with pytest.raises(SystemExit):
        p.parse_args(["--backend", "xla"])


def test_numerics_has_no_backend_field():
    import dataclasses

    import tpuvof as tv

    names = {f.name for f in dataclasses.fields(tv.Numerics)}
    assert "backend" not in names and "pressure_solver" in names


# ---- trace reduction ------------------------------------------------------
HLO = """\
HloModule jit__simulate_impl, entry_computation_layout={()}

ENTRY %main {
  %p0 = f32[4,4]{1,0} parameter(0)
  %gte = f32[4,4]{1,0} get-tuple-element(%t), index=0
  %wrapped_slice.9 = f32[2,4]{1,0} fusion(%p0), kind=kLoop, calls=%c, metadata={op_name="jit(f)/while/body/closed_call/pressure/closed_call/slice"}
  %loop_dynamic_update_slice_fusion.3 = f32[4,4]{1,0} fusion(%p0, %wrapped_slice.9), kind=kLoop, metadata={op_name="jit(f)/while/body/closed_call/pressure/scatter"}
  %loop_multiply_fusion = (f32[4,4]{1,0}, f32[4,4]{1,0}) fusion(%p0, %gte), kind=kLoop, metadata={op_name="jit(f)/while/body/closed_call/fct_y/mul"}
  ROOT %copy.1 = f32[4,4]{1,0} copy(%p0), metadata={op_name="jit(f)/while/body/closed_call/bc/copy"}
}
"""


def test_phase_of_picks_the_innermost_solver_scope():
    assert profiling.phase_of("jit(f)/while/body/closed_call/fct_x/mul") \
        == "fct_x"
    assert profiling.phase_of("jit(f)/while/body/closed_call/mul") == "other"
    assert profiling.phase_of("") == "other"


def test_hlo_index_names_phases_and_bytes():
    idx = profiling.hlo_index(HLO)
    assert idx["wrapped_slice_9"] == ("pressure", 32 + 64)
    # dynamic-update-slice in place: the aliased operand and result drop
    # out, the update is read and written once
    assert idx["loop_dynamic_update_slice_fusion_3"] == ("pressure", 64)
    # tuple-typed (multi-output) fusion: both results plus both operands
    assert idx["loop_multiply_fusion"] == ("fct_y", 128 + 128)
    assert idx["copy_1"] == ("bc", 128)
    assert "p0" not in idx and "gte" not in idx


def test_busy_ns_is_the_union_of_intervals():
    assert profiling.busy_ns([]) == 0.0
    assert profiling.busy_ns([(0, 10), (5, 15), (20, 30)]) == 25.0
    assert profiling.busy_ns([(20, 30), (0, 40)]) == 40.0


def test_reduce_events_phase_table():
    idx = profiling.hlo_index(HLO)
    events = [("wrapped_slice_9", 0, 10), ("loop_multiply_fusion", 10, 30),
              ("MemcpyD2D", 50, 10), ("wrapped_slice_9", 60, 10)]
    r = profiling.reduce_events(events, idx, peak_bytes_per_s=1e9,
                                n_steps=2)
    assert r["window_ns"] == 70 and r["busy_ns"] == 60
    assert r["idle_share"] == pytest.approx(10 / 70)
    pr = r["phases"]["pressure"]
    assert pr["launches"] == 2 and pr["time_ns"] == 20
    assert pr["bytes_per_s"] == pytest.approx(2 * 96 / 20e-9)
    assert pr["time_per_step_us"] == pytest.approx(0.01)
    assert r["phases"]["other"]["bytes"] == 0  # the copy is not in the HLO
    assert r["top_kernels"][0]["kernel"] == "loop_multiply_fusion"
    with pytest.raises(ValueError):
        profiling.reduce_events([], idx, 1e9, 1)
