"""chip_smoke.py and bench.py on the CPU: every smoke phase's checks at tiny
sizes, and both entry points' refusal to run without a GPU."""
import importlib.util
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PHASES = ["golden_f64", "gpu_vs_cpu", "jacobi_2d", "mg", "rbsor",
          "decomp_1x1", "diff", "cli", "jacobi_3d"]


@pytest.mark.parametrize("name", PHASES)
def test_one_gpu_phase_passes_at_tiny_size(smoke, name, monkeypatch):
    """Each phase of the one-GPU run, at chip_smoke.TINY on the CPU: every
    check within its bound (the CLI phase with matplotlib and PIL
    blocked, as on a machine without them)."""
    phases = dict(zip(PHASES, smoke.one_gpu_phases(smoke.TINY)))
    if name == "cli":
        for mod in ("matplotlib", "PIL"):
            monkeypatch.setitem(sys.modules, mod, None)
    ph = phases[name](smoke.TINY)
    assert ph.checks, ph.name
    assert ph.ok, ph.line("cpu")


@pytest.mark.parametrize("name", ["decomp_2x2_jacobi", "decomp3d_pencils"])
def test_multi_phase_passes_at_tiny_size(smoke, name):
    """Two of the --multi phases on 4 of the virtual CPU devices: shards on
    distinct devices, parity with the serial run."""
    phases = dict(zip(["decomp_2x2_jacobi", "decomp_2x2_mg",
                       "decomp3d_slabs", "decomp3d_pencils"],
                      smoke.multi_phases(smoke.TINY)))
    ph = phases[name](smoke.TINY)
    assert any(c[0] == "one_shard_per_device" and c[3] for c in ph.checks)
    assert ph.ok, ph.line("cpu")


def test_phase_fails_when_a_bound_is_missed(smoke):
    ph = smoke.Phase("x")
    ph.check("a", 1.0, 2.0)
    assert ph.ok and "[ok]" in ph.line("gpu")
    ph.check("b", 3.0, 2.0)
    assert not ph.ok and "FAIL" in ph.line("gpu")


@pytest.mark.parametrize("script,args", [("chip_smoke.py", []),
                                         ("chip_smoke.py", ["--multi"]),
                                         ("bench.py", [])])
def test_entry_points_refuse_without_gpu(script, args):
    """On the CPU both measuring entry points exit non-zero and print no
    result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, script), *args],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "cell_updates" not in r.stdout
    assert "no GPU" in r.stderr


def test_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script fails before it prints anything."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
