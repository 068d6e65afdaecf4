"""Grid sweep of the XLA solver on one GPU: cell-updates/s of the dam
break at several 2-D and 3-D grid sizes (Jacobi pressure solve).

    python benchmarks/sweep.py              # 256..2048^2, 128^3 and 200^3
    python benchmarks/sweep.py --quick      # 256^2, 512^2 and 128^3 only

One JSON line per cell (each with the device it ran on), then a table.
Each cell compiles and warms once, then takes the best of 3 runs ended by
`jax.block_until_ready`. Exits non-zero without a GPU or when a cell
fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def best_seconds(run) -> float:
    import jax

    jax.block_until_ready(run())  # compile + warm
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    return min(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--steps2d", type=int, default=1000)
    ap.add_argument("--steps3d", type=int, default=100)
    args = ap.parse_args()

    from tpuvof.utils.runtime import (device_record, enable_compile_cache,
                                      require_gpu)

    require_gpu()
    enable_compile_cache()
    import tpuvof as tv

    device = device_record()
    rows = []
    for n in [256, 512] if args.quick else [256, 512, 1024, 2048]:
        cfg = tv.dam_break_2d(n)
        s = tv.init_state(cfg, ic=1)
        secs = best_seconds(lambda: tv.simulate(cfg, s, args.steps2d))
        rows.append({"workload": f"{n}^2 dam break x{args.steps2d}",
                     "seconds": secs,
                     "cups": n * n * args.steps2d / secs, **device})
        print(json.dumps(rows[-1]), flush=True)
    for n in [128] if args.quick else [128, 200]:
        g = tv.Grid3D(n, n, n)
        s = tv.init_state_3d(g, ic=1)
        secs = best_seconds(lambda: tv.simulate_3d(g, s, args.steps3d))
        rows.append({"workload": f"{n}^3 dam break x{args.steps3d}",
                     "seconds": secs,
                     "cups": n ** 3 * args.steps3d / secs, **device})
        print(json.dumps(rows[-1]), flush=True)
    print(f"\n{'workload':32s} {'seconds':>9s} {'CUPS':>12s}   "
          f"({device['gpu']})")
    for r in rows:
        print(f"{r['workload']:32s} {r['seconds']:9.4f} {r['cups']:12.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
