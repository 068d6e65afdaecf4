"""Per-phase device time of the solver step on the GPU, from a profiler trace.

    python scripts/trace_phases.py [--out DIR]

For 512^2 2-D Jacobi (20 steps) and 200^3 3-D Jacobi (6 steps): compile and
warm the exact program, trace one run of it with `jax.profiler`, and reduce
the trace (tpuvof.utils.profiling.reduce_trace) to the device time,
launches, bytes/s and share of the card's memory bandwidth of each phase
of the step, plus the window's idle share and its top kernels. Prints one
table per case and writes the reductions as JSON under --out.

Run it in a process of its own: tracing slows the host, so no timing is
taken from this run.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

#: memory bandwidth by device_kind (NVIDIA H100 SXM data sheet)
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def cases():
    import tpuvof as tv
    from tpuvof.solver import _simulate_impl
    from tpuvof.solver3d import _simulate_3d_impl

    cfg = tv.dam_break_2d(512)
    s2 = tv.init_state(cfg, ic=1)
    yield ("jacobi_2d_512", 20, lambda: tv.simulate(cfg, s2, 20),
           lambda: _simulate_impl.lower(cfg, s2, 20, 0))
    g = tv.Grid3D(200, 200, 200)
    s3 = tv.init_state_3d(g, ic=1)
    yield ("jacobi_3d_200", 6, lambda: tv.simulate_3d(g, s3, 6),
           lambda: _simulate_3d_impl.lower(g, s3, 6, 4e-6, 10, None, 0))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/trace")
    args = ap.parse_args()

    import jax

    from tpuvof.utils.profiling import PHASES, reduce_trace, trace
    from tpuvof.utils.runtime import (enable_compile_cache,
                                      gpu_name_and_power_limit, require_gpu)

    dev = require_gpu()[0]
    peak = PEAK_BYTES_PER_S[dev.device_kind]
    enable_compile_cache()
    print(f"gpu: {gpu_name_and_power_limit()}")
    for name, n_steps, run, lower in cases():
        hlo = lower().compile().as_text()
        jax.block_until_ready(run())
        logdir = os.path.join(args.out, name)
        with trace(logdir):
            jax.block_until_ready(run())
        r = reduce_trace(logdir, hlo, peak, n_steps)
        with open(logdir + ".json", "w") as f:
            json.dump(r, f, indent=1)
        print(f"\n{name}: {r['step_us']:.1f} us/step, idle share "
              f"{r['idle_share']:.4f}, {r['launches_per_step']:.1f} "
              "launches/step")
        print(f"  {'phase':<12}{'us/step':>10}{'busy %':>8}{'launch/st':>10}"
              f"{'TB/s':>8}{'% of BW':>9}")
        order = list(PHASES) + ["other"]
        for ph in sorted(r["phases"], key=order.index):
            v = r["phases"][ph]
            print(f"  {ph:<12}{v['time_per_step_us']:>10.1f}"
                  f"{100 * v['share_of_busy']:>8.1f}"
                  f"{v['launches'] / n_steps:>10.1f}"
                  f"{v['bytes_per_s'] / 1e12:>8.2f}"
                  f"{100 * v['share_of_peak_bw']:>9.1f}")
        for k in r["top_kernels"][:8]:
            print(f"    {k['kernel']:<44}{k['phase']:<12}"
                  f"{k['time_ns'] / n_steps / 1e3:>9.1f} us/step"
                  f"{k['bytes_per_s'] / 1e12:>7.2f} TB/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
