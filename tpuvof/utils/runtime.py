"""Run-time setup shared by the entry points (CLI, bench.py, chip_smoke.py).

- `enable_compile_cache`: JAX's persistent compilation cache. Where
  `JAX_COMPILATION_CACHE_DIR` is set JAX reads it itself and nothing is set
  here; otherwise the cache goes to the fixed `<checkout>/.jax_cache`
  (git-ignored). The path is part of what makes a cache hit, so it never
  depends on a temporary directory, a process id or the time.
- `require_gpu` / `device_record`: the measuring entry points refuse to run
  anywhere but on a GPU, and label every result with the device it ran on.
"""
from __future__ import annotations

import os
import subprocess

__all__ = ["compile_cache_dir", "enable_compile_cache", "require_gpu",
           "device_record", "gpu_name_and_power_limit"]

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir(environ=None) -> str | None:
    """The directory this process should set as JAX's compilation cache,
    or None where `JAX_COMPILATION_CACHE_DIR` already names one (JAX then
    uses it without help)."""
    environ = os.environ if environ is None else environ
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    import jax

    path = compile_cache_dir()
    if path is None:
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` as the tool prints it
    (one line per card), or "not available" where there is no such tool."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out.stdout.strip()


def require_gpu():
    """The JAX devices, after checking that the first is a GPU; raises
    RuntimeError otherwise (a measurement never falls back to the CPU)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX found {devs[0].platform} devices only; this "
            "entry point measures the GPU and runs nowhere else")
    return devs


def device_record() -> dict:
    """What every printed result carries about the machine it ran on."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices()),
            "gpu": gpu_name_and_power_limit(),
            "xla_flags": os.environ.get("XLA_FLAGS", "")}
