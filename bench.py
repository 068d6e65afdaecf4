"""Benchmark harness: cell-updates per second of the XLA solver on one GPU.

Runs every cell in this one process, each through the public entry points
(`simulate`, `simulate_3d`, `Decomp`): compile + warm once, then the best
of 3 timed runs, each ended by `jax.block_until_ready`. Prints ONE JSON
line: the headline 512^2 Jacobi rate, every cell's rate and seconds, and
the device it ran on (platform, device_kind, device count, the card's name
and power limit from nvidia-smi, XLA_FLAGS).

    python bench.py

Exits non-zero, printing no result, when JAX finds no GPU or when any cell
fails.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

N_REPEATS = 3


def best_of(run, state):
    """(compile + first run seconds, best steady seconds) of run(state)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(run(state))
    first = time.perf_counter() - t0
    times = []
    for _ in range(N_REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(run(state))
        times.append(time.perf_counter() - t0)
    return first, min(times)


def cell_2d(tv, n, n_steps, **num):
    cfg = tv.SimConfig(grid=tv.Grid2D(n, n), num=tv.Numerics(**num))
    state = tv.init_state(cfg, ic=1)
    return n * n, n_steps, best_of(lambda s: tv.simulate(cfg, s, n_steps),
                                   state)


def cell_3d(tv, n, n_steps):
    g = tv.Grid3D(n, n, n)
    state = tv.init_state_3d(g, ic=1)
    return n ** 3, n_steps, best_of(lambda s: tv.simulate_3d(g, s, n_steps),
                                    state)


def cell_dist_1x1(tv, n, n_steps, **num):
    """512^2 through Decomp on a 1x1 mesh: the cost of the shard
    machinery on one card, on the device-resident blocked state."""
    import jax
    from jax.sharding import Mesh
    from tpuvof.parallel import Decomp

    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("mx", "my"))
    cfg = tv.SimConfig(grid=tv.Grid2D(n, n), num=tv.Numerics(**num))
    dec = Decomp(cfg, mesh)
    run = dec.make_simulate()
    blocked = dec.scatter_state(tv.init_state(cfg, ic=1))
    return n * n, n_steps, best_of(lambda b: run(b, n_steps), blocked)


MG_REL = dict(pressure_solver="mg", sor_tol=0.0, sor_tol_rel=1e-2,
              sor_max_iter=50)

CELLS = {
    "cups_512": lambda tv: cell_2d(tv, 512, 1000),
    "cups_2048": lambda tv: cell_2d(tv, 2048, 500),
    "cups_3d_200": lambda tv: cell_3d(tv, 200, 100),
    "cups_3d_256": lambda tv: cell_3d(tv, 256, 100),
    "cups_512_rbsor": lambda tv: cell_2d(tv, 512, 200,
                                         pressure_solver="rbsor"),
    "cups_512_mg_rel1e2": lambda tv: cell_2d(tv, 512, 200, **MG_REL),
    "cups_dist_512_1x1": lambda tv: cell_dist_1x1(tv, 512, 1000),
    "cups_dist_mg_rel1e2": lambda tv: cell_dist_1x1(tv, 512, 200, **MG_REL),
}


def main() -> int:
    from tpuvof.utils.runtime import (device_record, enable_compile_cache,
                                      require_gpu)

    try:
        require_gpu()
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    enable_compile_cache()
    import tpuvof as tv

    record = {"metric": "cell_updates_per_sec_512",
              "unit": "cells*steps/s", **device_record()}
    for key, cell in CELLS.items():
        cells, n_steps, (first, best) = cell(tv)
        record[key] = cells * n_steps / best
        record[key + "_seconds"] = best
        record[key + "_first_call_seconds"] = first
    record["value"] = record["cups_512"]
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
