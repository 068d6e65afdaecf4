"""Time the 512^2 dam break (1000 steps, f32) on the host CPU with XLA:CPU.

A reference point for the CPU backend only — never a device metric and
never a baseline for a GPU number:

    python scripts/measure_baseline.py
"""
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tpuvof as tv  # noqa: E402


def main():
    n, n_steps = 512, 1000
    cfg = tv.dam_break_2d(n)
    state = tv.init_state(cfg, ic=1)
    jax.block_until_ready(tv.simulate(cfg, state, n_steps))  # compile
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        jax.block_until_ready(tv.simulate(cfg, state, n_steps))
        times.append(time.perf_counter() - t0)
    print(json.dumps({"platform": "cpu",
                      "cell_updates_per_sec_512": n * n * n_steps / min(times),
                      "seconds_per_1000_steps_512": min(times)}))


if __name__ == "__main__":
    main()
