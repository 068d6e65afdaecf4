"""Smoke test of tpuvof on the GPU: the main paths, end to end, at real sizes.

    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --multi    # four GPUs: the distributed phases only

One process runs every phase through the public entry points (`simulate`,
`simulate_3d`, `Decomp`/`Decomp3D`, `diff.optimize_f0`'s epoch functions,
`tpuvof.cli.main`). Each phase prints one line: its checks, each measured
value beside its bound, its wall time after warm-up (best of 3, each run
ended by `jax.block_until_ready`), its compile time (first call minus the
best run), cell-updates/s where that applies, and the card's name and
power limit. The last line is one JSON object naming the device.

The 3-D four-GPU phases check the state after a few steps and time that
same compiled program called back to back over as many steps as the
one-GPU 3-D phase, beside the serial run on the first card timed the same
way.

Exits non-zero, and prints no last line, when JAX finds no GPU, when a
phase raises, or when any check misses its bound.

Two f32 runs of this flow that differ only in rounding order (another
device, another fusion) do not stay close: a few interface cells flip a
limiter or clamp decision within the first steps, and the difference at
those cells saturates at the field's own scale. So a comparison after many
steps is bounded by the flow's own rounding sensitivity, measured in the
same run as |f32 - f64| of the reference, and checked both as max |Δ| and
as the relative L2 norm of Δ; the comparison after ONE step, before any
flip, is held to 1e-5 of each field's scale.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

FULL = dict(n2d=512, steps2d=1000, n3d=200, steps3d=100, steps_solver=200,
            n_diff=80, steps_diff=999, n_cli=200, steps_cli=200,
            steps_dist=100, steps_xcheck=100, steps3d_multi=3)
#: sizes the CPU tests run every phase at
TINY = dict(n2d=32, steps2d=20, n3d=16, steps3d=6, steps_solver=6,
            n_diff=16, steps_diff=10, n_cli=32, steps_cli=10,
            steps_dist=6, steps_xcheck=6, steps3d_multi=3)
MG_REL = dict(pressure_solver="mg", sor_tol=0.0, sor_tol_rel=1e-2,
              sor_max_iter=50)
#: relative mass change allowed over a production phase (FCT with the
#: [0, 1] clamp conserves liquid volume only up to the clamped overshoot)
MASS_DRIFT = 1e-4
#: rounding-seeded differences may reach this multiple of |f32 - f64|
ROUNDING_FACTOR = 4.0
FIELDS_2D = ("F", "u", "v", "p")
FIELDS_3D = ("F", "u", "v", "w", "p")


class Phase:
    """The checks and numbers of one phase, printed as one line."""

    def __init__(self, name: str):
        self.name = name
        self.checks: list[tuple[str, float, str, bool]] = []
        self.info: dict[str, object] = {}

    def check(self, label: str, value, bound, ok: bool | None = None,
              op: str = "<="):
        value = float(value)
        if ok is None:
            ok = value <= bound if op == "<=" else value < bound
        self.checks.append((label, value, f"{op} {bound:.3g}", bool(ok)))

    def require(self, label: str, ok: bool):
        self.checks.append((label, float(bool(ok)), "== 1", bool(ok)))

    @property
    def ok(self) -> bool:
        return all(c[3] for c in self.checks)

    def line(self, gpu: str) -> str:
        checks = "; ".join(f"{label}={value:.4g} ({bound}){'' if ok else ' FAIL'}"
                           for label, value, bound, ok in self.checks)
        info = " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                        for k, v in self.info.items())
        return (f"[{'ok' if self.ok else 'FAIL'}] {self.name}: {checks} | "
                f"{info} | gpu: {gpu}")


def timed(run):
    """(first-call seconds, best of 3 seconds, result) of run()."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(run())
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run())
        best = min(best, time.perf_counter() - t0)
    return first, best, out


def chained(run, state, steps: int, window: int):
    """(callable, steps it takes): `run(state, steps, istep0)` called back
    to back until `window` steps are taken — one compiled program timed
    over a window as long as another phase's."""
    reps = -(-window // steps)

    def go():
        s = state
        for k in range(reps):
            s = run(s, steps, k * steps)
        return s

    return go, reps * steps


def record_timing(ph: Phase, first: float, best: float, cells: int,
                  steps: int):
    ph.info["best_s"] = best
    ph.info["compile_s"] = max(first - best, 0.0)
    if cells:
        ph.info["cups"] = cells * steps / best


def physical(ph: Phase, state, state0):
    """finite fields, 0 <= F <= 1, mass drift, CFL of the end state."""
    interior = (slice(1, -1),) * np.asarray(state.F).ndim
    F = np.asarray(state.F, np.float64)
    ph.require("finite", all(np.isfinite(np.asarray(a)).all()
                             for a in state))
    ph.check("F_min", F.min(), 0.0, ok=F.min() >= 0.0, op=">=")
    ph.check("F_max", F.max(), 1.0)
    m0 = float(np.asarray(state0.F, np.float64)[interior].sum())
    ph.check("mass_drift", abs(float(F[interior].sum()) - m0) / m0,
             MASS_DRIFT)


def cfl(ph: Phase, state, dt: float, dx: float):
    vmax = max(float(np.abs(np.asarray(a)).max()) for a in state[1:-1])
    ph.info["cfl"] = vmax * dt / dx


def compare(ph: Phase, tag: str, got, want, ref64, fields):
    """max |Δ| and relative L2 of got - want, each bounded by
    ROUNDING_FACTOR x the same measure of want - ref64."""
    for f in fields:
        a = np.asarray(getattr(got, f), np.float64)
        b = np.asarray(getattr(want, f), np.float64)
        r = np.asarray(getattr(ref64, f), np.float64)
        gap_max = np.abs(b - r).max()
        gap_l2 = np.linalg.norm(b - r) / max(np.linalg.norm(r), 1e-300)
        ph.check(f"{tag}_max|d{f}|", np.abs(a - b).max(),
                 ROUNDING_FACTOR * gap_max + 1e-12)
        ph.check(f"{tag}_l2rel_d{f}",
                 np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300),
                 ROUNDING_FACTOR * gap_l2 + 1e-12)


def compare_one_step(ph: Phase, got, want, fields, bound: float = 1e-5):
    """max |Δ| over each field's scale after one step. A residual-driven
    solve stops at a relative tolerance, so two runs whose reductions
    differ may stop one iteration apart: pass that tolerance as bound."""
    for f in fields:
        a = np.asarray(getattr(got, f), np.float64)
        b = np.asarray(getattr(want, f), np.float64)
        scale = max(np.abs(b).max(), 1e-30)
        ph.check(f"step1_max|d{f}|/scale", np.abs(a - b).max() / scale,
                 bound)


def as_dtype(state, dtype):
    import jax.numpy as jnp

    return type(state)(*(jnp.asarray(np.asarray(a), dtype) for a in state))


def solve_iterations(cfg, state) -> int:
    """V-cycles (mg) or red+black iterations (rbsor) the pressure solve of
    `simulate`'s first step from `state` takes, as `solver.step_counted`
    reports it."""
    import jax

    from tpuvof.ops import apply_bc
    from tpuvof.solver import step_counted

    @jax.jit
    def count(state):
        u, v, F, p = apply_bc(state.u, state.v, state.F, state.p)
        return step_counted(cfg, type(state)(F=F, u=u, v=v, p=p),
                            even_step=False, lean=True)[1]

    return int(count(state))


# ---------------------------------------------------------------------------
# one-GPU phases
# ---------------------------------------------------------------------------
def phase_golden_f64(sz) -> Phase:
    """The executable spec's goldens, with x64 on for this phase only."""
    import jax
    import jax.numpy as jnp

    import tpuvof as tv

    ph = Phase("golden_f64")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with jax.enable_x64(True):
        z = np.load(os.path.join(here, "tests", "golden_dambreak_64_1000.npz"))
        n = int(z["n"])
        cfg = tv.SimConfig(grid=tv.Grid2D(n, n))
        s0 = tv.init_state(cfg, ic=1)
        mid = tv.simulate(cfg, as_dtype(s0, jnp.float64), int(z["checkpoint"]))
        end = tv.simulate(cfg, as_dtype(s0, jnp.float64), int(z["n_steps"]))
        f32 = tv.simulate(cfg, as_dtype(s0, jnp.float32), int(z["n_steps"]))
        for f in ("F", "u"):
            ph.check(f"2d_step{int(z['checkpoint'])}_max|d{f}|",
                     np.abs(np.asarray(getattr(mid, f)) - z[f + "300"]).max(),
                     1e-8)
            ph.check(f"2d_step{int(z['n_steps'])}_max|d{f}|",
                     np.abs(np.asarray(getattr(end, f)) - z[f]).max(), 1e-5)
        ph.check("2d_f32_drift_max|dF|",
                 np.abs(np.asarray(f32.F, np.float64) - z["F"]).max(), 5e-3)

        z3 = np.load(os.path.join(here, "tests",
                                  "golden_dambreak3d_32_300.npz"))
        n3 = int(z3["n"])
        g = tv.Grid3D(n3, n3, n3)
        s3 = as_dtype(tv.init_state_3d(g, ic=1), jnp.float64)
        k = int(z3["checkpoint"])
        mid3 = tv.simulate_3d(g, s3, k)
        end3 = tv.simulate_3d(g, mid3, int(z3["n_steps"]) - k, istep0=k)
        for f in ("F", "u"):
            ph.check(f"3d_step{k}_max|d{f}|",
                     np.abs(np.asarray(getattr(mid3, f)) - z3[f + "100"]).max(),
                     1e-9)
            ph.check(f"3d_step{int(z3['n_steps'])}_max|d{f}|",
                     np.abs(np.asarray(getattr(end3, f)) - z3[f]).max(), 1e-9)
    ph.info["wall_s"] = time.perf_counter() - t0
    return ph


def phase_gpu_vs_cpu(sz) -> Phase:
    """The same program on the GPU and on the host CPU."""
    import jax
    import jax.numpy as jnp

    import tpuvof as tv

    ph = Phase(f"gpu_vs_cpu_{sz['n2d']}")
    cpu = jax.devices("cpu")[0]
    cfg = tv.dam_break_2d(sz["n2d"])
    s0 = as_dtype(tv.init_state(cfg, ic=1), jnp.float32)
    n = sz["steps_xcheck"]
    gpu1 = tv.simulate(cfg, s0, 1)
    gpu = tv.simulate(cfg, s0, n)
    with jax.default_device(cpu):
        s0c = jax.device_put(s0, cpu)
        cpu1 = tv.simulate(cfg, s0c, 1)
        cpu32 = tv.simulate(cfg, s0c, n)
        with jax.enable_x64(True):
            cpu64 = tv.simulate(cfg, as_dtype(s0, jnp.float64), n)
    ph.info["devices"] = f"{gpu.F.devices().pop().platform}/" \
                         f"{cpu32.F.devices().pop().platform}"
    compare_one_step(ph, gpu1, cpu1, FIELDS_2D)
    compare(ph, f"step{n}", gpu, cpu32, cpu64, FIELDS_2D)
    return ph


def phase_jacobi_2d(sz) -> Phase:
    import tpuvof as tv

    n, steps = sz["n2d"], sz["steps2d"]
    ph = Phase(f"jacobi_2d_{n}x{n}x{steps}")
    cfg = tv.dam_break_2d(n)
    s0 = tv.init_state(cfg, ic=1)
    first, best, out = timed(lambda: tv.simulate(cfg, s0, steps))
    physical(ph, out, s0)
    cfl(ph, out, cfg.num.dt, cfg.grid.dx)
    record_timing(ph, first, best, n * n, steps)
    return ph


def phase_solver_2d(sz, solver: str) -> Phase:
    import tpuvof as tv

    n, steps = sz["n2d"], sz["steps_solver"]
    num = MG_REL if solver == "mg" else dict(pressure_solver="rbsor")
    ph = Phase(f"{solver}_2d_{n}x{n}x{steps}")
    cfg = tv.SimConfig(grid=tv.Grid2D(n, n), num=tv.Numerics(**num))
    s0 = tv.init_state(cfg, ic=1)
    first, best, out = timed(lambda: tv.simulate(cfg, s0, steps))
    physical(ph, out, s0)
    cfl(ph, out, cfg.num.dt, cfg.grid.dx)
    ph.info["iters_first_step"] = solve_iterations(cfg, s0)
    ph.info["iters_last_step"] = solve_iterations(cfg, out)
    ph.info["iters_cap"] = cfg.num.sor_max_iter
    record_timing(ph, first, best, n * n, steps)
    return ph


def phase_jacobi_3d(sz) -> Phase:
    import jax

    import tpuvof as tv

    n, steps = sz["n3d"], sz["steps3d"]
    ph = Phase(f"jacobi_3d_{n}^3x{steps}")
    g = tv.Grid3D(n, n, n)
    s0 = tv.init_state_3d(g, ic=1)
    first, best, out = timed(lambda: tv.simulate_3d(g, s0, steps))
    physical(ph, out, s0)
    cfl(ph, out, 4e-6, g.dx)
    record_timing(ph, first, best, n ** 3, steps)
    stats = jax.devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        ph.info["peak_mem_gb"] = stats["peak_bytes_in_use"] / 1e9
    return ph


def phase_decomp_1x1(sz) -> Phase:
    """Decomp on a 1x1 mesh against serial `simulate` on the same card."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import tpuvof as tv
    from tpuvof.parallel import Decomp

    n, steps = sz["n2d"], sz["steps_dist"]
    ph = Phase(f"decomp_1x1_{n}x{n}x{steps}")
    cfg = tv.dam_break_2d(n)
    s0 = as_dtype(tv.init_state(cfg, ic=1), jnp.float32)
    dec = Decomp(cfg, Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                           ("mx", "my")))
    run = dec.make_simulate()
    blocked = dec.scatter_state(s0)
    first, best, out = timed(lambda: run(blocked, steps))
    got = dec.gather_state(out)
    want = tv.simulate(cfg, s0, steps)
    with jax.enable_x64(True):
        ref64 = tv.simulate(cfg, as_dtype(s0, jnp.float64), steps)
    compare_one_step(ph, dec.simulate(s0, 1), tv.simulate(cfg, s0, 1),
                     FIELDS_2D)
    compare(ph, f"step{steps}", got, want, ref64, FIELDS_2D)
    physical(ph, got, s0)
    record_timing(ph, first, best, n * n, steps)
    return ph


def phase_diff(sz) -> Phase:
    """Two epochs of the differentiable F0 optimization (diff_vof.py):
    the loss of the F0 each epoch leaves behind, and its gradients."""
    import jax
    import jax.numpy as jnp

    from tpuvof import diff

    n, steps = sz["n_diff"], sz["steps_diff"]
    ph = Phase(f"diff_{n}x{n}x{steps}_fwd+bwd")
    cfg = diff.diff_config(n=n)
    target = diff.diff_target(cfg, 1)
    opts = diff.DiffOptions(n_steps=steps)

    def epoch(F0):
        loss, grad = diff.loss_and_grad(cfg, F0, target, steps, opts.remat)
        return diff.apply_grad(F0, grad, opts.lr, opts.grad_gate), loss, grad

    F0 = jnp.zeros(cfg.grid.shape, jnp.float32)
    t0 = time.perf_counter()
    F1, loss0, g0 = jax.block_until_ready(epoch(F0))
    first = time.perf_counter() - t0
    F2, loss1, g1 = epoch(F1)
    _, loss2, g2 = epoch(F2)
    ph.require("grad_finite", all(np.isfinite(np.asarray(g)).all()
                                  for g in (g0, g1, g2)))
    ph.check("loss_after_epoch2", float(loss2), float(loss1), op="<")
    ph.info["loss_initial"] = float(loss0)
    ph.info["loss_after_epoch1"] = float(loss1)
    ph.info["max|grad|"] = float(np.abs(np.asarray(g0)).max())
    _, best, _ = timed(lambda: epoch(F1))
    ph.info["epoch_best_s"] = best
    ph.info["compile_s"] = max(first - best, 0.0)
    return ph


def _png_size(path: str) -> tuple[int, int]:
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24],
                                                                "big")


def phase_cli(sz) -> Phase:
    """`tpuvof.cli.main` in this process, PNG frames on."""
    from tpuvof import cli

    n, steps = sz["n_cli"], sz["steps_cli"]
    every = max(steps // 2, 1)
    ph = Phase(f"cli_{n}x{n}x{steps}")
    with tempfile.TemporaryDirectory() as out:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-ic", "1", "--nx", str(n), "--steps", str(steps),
                           "--frame-every", str(every), "--outdir", out])
        ph.info["wall_s"] = time.perf_counter() - t0
        frames = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        ph.check("exit_code", rc, 0)
        ph.check("png_frames", len(frames), -(-steps // every), op=">=",
                 ok=len(frames) >= -(-steps // every))
        sizes = {_png_size(os.path.join(out, f)) for f in frames}
        ph.require("png_size_2n", sizes == {(2 * n, 2 * n)})
    ph.require("no_matplotlib_or_PIL",
               all(sys.modules.get(m) is None for m in ("matplotlib", "PIL")))
    ph.info["stdout_lines"] = len(buf.getvalue().splitlines())
    return ph


# ---------------------------------------------------------------------------
# four-GPU phases (--multi)
# ---------------------------------------------------------------------------
def _shard_devices(ph: Phase, blocked, n_dev: int):
    devs = sorted(str(s.device) for s in blocked.F.addressable_shards)
    ph.info["shards_on"] = ",".join(devs)
    ph.require("one_shard_per_device", len(set(devs)) == n_dev
               and len(devs) == n_dev)


def phase_multi_2d(sz, solver: str) -> Phase:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import tpuvof as tv
    from tpuvof.parallel import Decomp

    n, steps = sz["n2d"], sz["steps_dist"]
    num = MG_REL if solver == "mg" else {}
    ph = Phase(f"decomp_2x2_{solver}_{n}x{n}x{steps}")
    cfg = tv.SimConfig(grid=tv.Grid2D(n, n), num=tv.Numerics(**num))
    s0 = as_dtype(tv.init_state(cfg, ic=1), jnp.float32)
    dec = Decomp(cfg, Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                           ("mx", "my")))
    run = dec.make_simulate()
    blocked = dec.scatter_state(s0)
    _shard_devices(ph, blocked, 4)
    first, best, out = timed(lambda: run(blocked, steps))
    got = dec.gather_state(out)
    with jax.default_device(jax.devices()[0]):
        want = tv.simulate(cfg, s0, steps)
        with jax.enable_x64(True):
            ref64 = tv.simulate(cfg, as_dtype(s0, jnp.float64), steps)
        compare_one_step(ph, dec.simulate(s0, 1), tv.simulate(cfg, s0, 1),
                         FIELDS_2D, max(1e-5, cfg.num.sor_tol_rel))
    compare(ph, f"step{steps}", got, want, ref64, FIELDS_2D)
    physical(ph, got, s0)
    record_timing(ph, first, best, n * n, steps)
    return ph


def phase_multi_3d(sz, layout: str) -> Phase:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import tpuvof as tv
    from tpuvof.parallel import Decomp3D

    n, steps = sz["n3d"], sz["steps3d_multi"]
    devs = np.array(jax.devices()[:4])
    mesh = (Mesh(devs, ("mx",)) if layout == "slabs"
            else Mesh(devs.reshape(2, 2), ("mx", "my")))
    ph = Phase(f"decomp3d_{layout}_{n}^3x{steps}")
    g = tv.Grid3D(n, n, n)
    s0 = as_dtype(tv.init_state_3d(g, ic=1), jnp.float32)
    dec = Decomp3D(g, mesh)
    run = dec.make_simulate()
    blocked = dec.scatter_state(s0)
    _shard_devices(ph, blocked, 4)
    got = dec.gather_state(run(blocked, steps))
    go, window = chained(run, blocked, steps, sz["steps3d"])
    first, best, _ = timed(go)
    with jax.default_device(jax.devices()[0]):
        want = tv.simulate_3d(g, s0, steps)
        serial, _ = chained(
            lambda s, k, i0: tv.simulate_3d(g, s, k, istep0=i0), s0, steps,
            window)
        _, serial_best, _ = timed(serial)
        with jax.enable_x64(True):
            ref64 = tv.simulate_3d(g, as_dtype(s0, jnp.float64), steps)
        compare_one_step(ph, dec.simulate(s0, 1), tv.simulate_3d(g, s0, 1),
                         FIELDS_3D)
    compare(ph, f"step{steps}", got, want, ref64, FIELDS_3D)
    physical(ph, got, s0)
    record_timing(ph, first, best, n ** 3, window)
    ph.info["timed_steps"] = window
    ph.info["serial_best_s"] = serial_best
    ph.info["speedup_vs_1_card"] = serial_best / best
    return ph


def one_gpu_phases(sz):
    yield phase_golden_f64
    yield phase_gpu_vs_cpu
    yield phase_jacobi_2d
    yield lambda sz: phase_solver_2d(sz, "mg")
    yield lambda sz: phase_solver_2d(sz, "rbsor")
    yield phase_decomp_1x1
    yield phase_diff
    yield phase_cli
    yield phase_jacobi_3d


def multi_phases(sz):
    yield lambda sz: phase_multi_2d(sz, "jacobi")
    yield lambda sz: phase_multi_2d(sz, "mg")
    yield lambda sz: phase_multi_3d(sz, "slabs")
    yield lambda sz: phase_multi_3d(sz, "pencils")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU distributed phases")
    args = ap.parse_args(argv)

    import jax

    from tpuvof.utils.runtime import (enable_compile_cache,
                                      gpu_name_and_power_limit, require_gpu)

    try:
        devs = require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if args.multi and len(devs) < 4:
        print(f"chip_smoke: --multi needs 4 GPUs, found {len(devs)}",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    gpu = gpu_name_and_power_limit().replace("\n", " | ")
    print(f"devices: {[str(d) for d in devs]} XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    failed = []
    for phase in (multi_phases if args.multi else one_gpu_phases)(FULL):
        ph = phase(FULL)
        print(ph.line(gpu), flush=True)
        if not ph.ok:
            failed.append(ph.name)
    print(gpu, flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
