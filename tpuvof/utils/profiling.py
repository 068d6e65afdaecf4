"""Tracing and trace reduction (SURVEY.md §5: the reference has none — its
only instrumentation is print banners).

`trace` wraps a block in a `jax.profiler` trace. `reduce_trace` turns the
trace of a jitted program on a GPU into per-phase device metrics:

- the device events (kernels and copies) of the `/device:GPU:*` planes;
- each kernel joined to its HLO instruction in the compiled program's text
  (`compiled.as_text()`): the kernel is named after the fusion, and the
  fusion's `op_name` metadata carries the `jax.named_scope` phase the
  solver step sets (mix_normals, predict, pressure, correct, fct_x/y/z,
  bc);
- per phase: device time, launches, and the bytes the fusion's operands
  and result span (an upper bound of its DRAM traffic: slices read less,
  and L2 may serve repeats), as bytes/s and as a share of the card's
  memory bandwidth;
- the window's busy time (union of event intervals) and idle share.
"""
from __future__ import annotations

import contextlib
import glob
import os
import re
from collections import defaultdict

__all__ = ["trace", "PHASES", "phase_of", "hlo_index", "busy_ns",
           "device_events", "reduce_events", "reduce_trace"]

#: named scopes of the solver step, in pipeline order
PHASES = ("mix_normals", "predict", "pressure", "correct", "fct_x", "fct_y",
          "fct_z", "bc")

_DTYPE_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "s64": 8, "s32": 4,
                "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1}
_HEAD = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*")
_SHAPE = re.compile(r"(\w+)\[([\d,]*)\]")
_OPERAND = re.compile(r"%([\w.\-]+)")
_OP_NAME = re.compile(r'op_name="([^"]*)"')


@contextlib.contextmanager
def trace(logdir: str):
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def phase_of(op_name: str) -> str:
    """The innermost solver phase named in an HLO `op_name` path, or
    'other' (scan bookkeeping, the clamp, the entry BC outside a step)."""
    for part in reversed(op_name.split("/")):
        if part in PHASES:
            return part
    return "other"


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def _parse(line: str):
    """(name, result bytes, opcode, operand text, rest) of one HLO
    instruction line, or None. The result type may be an array shape or a
    tuple of them (multi-output fusions)."""
    m = _HEAD.match(line)
    if not m:
        return None
    name, rest = m.group(1), line[m.end():]
    if rest.startswith("("):
        depth = 0
        for i, c in enumerate(rest):
            depth += (c == "(") - (c == ")")
            if depth == 0:
                break
        rtype, rest = rest[:i + 1], rest[i + 1:]
    else:
        rtype, _, rest = rest.partition(" ")
    opcode, paren, rest = rest.strip().partition("(")
    if not paren or not _SHAPE.search(rtype):
        return None
    operands, _, rest = rest.partition(")")
    nbytes = sum(_shape_bytes(d, dims) for d, dims in _SHAPE.findall(rtype))
    return name, nbytes, opcode.strip(), operands, rest


def hlo_index(hlo_text: str) -> dict:
    """kernel name -> (phase, bytes) for every instruction of a compiled
    module's text that can become a kernel. Kernel names are the
    instruction names with '.' replaced by '_'. Bytes are the result's
    plus the operands'; a fusion rooted in a dynamic-update-slice writes
    its first operand in place, so that operand and the result are
    replaced by one write of its largest other operand."""
    sizes = {}
    rows = []
    for line in hlo_text.splitlines():
        parsed = _parse(line)
        if parsed is None:
            continue
        name, nbytes, opcode, operands, rest = parsed
        sizes[name] = nbytes
        rows.append((name, opcode, operands, rest))
    index = {}
    for name, opcode, operands, rest in rows:
        if opcode in ("parameter", "constant", "get-tuple-element"):
            continue
        ins = [sizes.get(o, 0) for o in _OPERAND.findall(operands)]
        if "dynamic_update_slice" in name and len(ins) > 1:
            nbytes = sum(ins[1:]) + max(ins[1:])
        else:
            nbytes = sizes[name] + sum(ins)
        op = _OP_NAME.search(rest)
        index[name.replace(".", "_")] = (phase_of(op.group(1) if op else ""),
                                         nbytes)
    return index


def busy_ns(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_events(xplane_path: str):
    """(name, start_ns, duration_ns) of every event on the GPU planes."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane_path)
    out = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                out.append((ev.name, ev.start_ns, ev.duration_ns))
    return out


def reduce_events(events, index: dict, peak_bytes_per_s: float,
                  n_steps: int) -> dict:
    """Per-phase device time, launches and bytes of a traced window.
    Events the index does not know (copies, library kernels) count
    under 'other' with no bytes."""
    if not events:
        raise ValueError("the trace holds no device events")
    t0 = min(s for _, s, _ in events)
    t1 = max(s + d for _, s, d in events)
    busy = busy_ns((s, s + d) for _, s, d in events)
    phases = defaultdict(lambda: {"time_ns": 0.0, "launches": 0,
                                  "bytes": 0})
    kernels = defaultdict(lambda: [0.0, 0, "other", 0])
    for name, _, dur in events:
        phase, nbytes = index.get(name, ("other", 0))
        ph = phases[phase]
        ph["time_ns"] += dur
        ph["launches"] += 1
        ph["bytes"] += nbytes
        k = kernels[name]
        k[0] += dur
        k[1] += 1
        k[2] = phase
        k[3] += nbytes
    for ph in phases.values():
        secs = ph["time_ns"] * 1e-9
        ph["bytes_per_s"] = ph["bytes"] / secs if secs else 0.0
        ph["share_of_peak_bw"] = ph["bytes_per_s"] / peak_bytes_per_s
        ph["time_per_step_us"] = ph["time_ns"] * 1e-3 / n_steps
        ph["share_of_busy"] = ph["time_ns"] / busy
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "window_ns": t1 - t0, "busy_ns": busy,
        "idle_share": 1.0 - busy / (t1 - t0),
        "step_us": (t1 - t0) * 1e-3 / n_steps,
        "launches_per_step": len(events) / n_steps,
        "phases": dict(phases),
        "top_kernels": [
            {"kernel": k, "phase": v[2], "time_ns": v[0], "launches": v[1],
             "bytes_per_s": v[3] / (v[0] * 1e-9) if v[0] else 0.0}
            for k, v in top],
    }


def reduce_trace(logdir: str, hlo_text: str, peak_bytes_per_s: float,
                 n_steps: int) -> dict:
    """`reduce_events` over the newest .xplane.pb under a trace dir."""
    paths = sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {logdir}")
    return reduce_events(device_events(paths[-1]), hlo_index(hlo_text),
                         peak_bytes_per_s, n_steps)
