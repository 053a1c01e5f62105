"""What every cell shares: the files that define it, the spans the harness
records around the program's calls, the reading of a profiler trace, and
the result line.

A cell is found by name.  `BENCHMARK.json` names its configuration and
traffic; `portbench/workloads/<cell>.json` its entry (the module under
`portbench/entries/` that drives the program), its limits and the cell's
own numbers; `portbench/traffic/<traffic>.json` the traffic's parameters;
the configuration's file the model as it is run.  A per-layer metric
`<base>.<suffix>` is read by `portbench/metrics/<base>.py`.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import sys
import time
from typing import Dict, List

import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")

# NVIDIA H100 SXM data sheet, dense: every share of a peak in the
# benchmark divides by these, whatever precision the work runs in
PEAK_FLOPS = 989e12          # bf16 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12   # HBM3

# top-level module names the measured process may not hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "taste_spokenlm_tpu")


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str, bench_path: str = BENCHMARK) -> Dict:
    """The cell `name` with its BENCHMARK.json entry, workload file,
    configuration file and metric lists merged:
    {"name", "config", "traffic", "chips", "workload": {...},
    "config_file": {...}, "end_to_end": [...], "per_layer": [...]}."""
    bench = load_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = dict(cells[name])
    configs = {c["name"]: c for c in bench["configs"]}
    cell["config_file"] = load_json(os.path.join(
        ROOT, configs[cell["config"]]["file"]))
    cell["workload"] = load_json(os.path.join(PKG_DIR, "workloads",
                                              name + ".json"))

    def mine(metric):
        return name in metric.get("workloads", [name])
    cell["end_to_end"] = [m for m in bench["end_to_end"] if mine(m)]
    cell["per_layer"] = [m for m in bench["per_layer"] if mine(m)]
    return cell


def float32_as_stated() -> None:
    """Products in float32 run in float32: cuDNN's convolutions (the
    whisper stem) default to TF32, which the configurations do not state
    for their float32 parts (the port's own CLIs turn it off too)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN_MODULES)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class Spans:
    """Host spans around the program's calls.  Off (`traced` False) a span
    costs nothing and records nothing.  On, each span is a profiler
    annotation `pb.<name>` and a duration, the device synchronized at
    its end so that the duration holds the span's device work."""

    def __init__(self, traced: bool, sync: bool):
        self.traced = traced
        self.sync = sync
        self.seconds: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.traced:
            yield
            return
        with torch.profiler.record_function("pb." + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self.sync:
                    torch.cuda.synchronize()
                self.seconds.setdefault(name, []).append(
                    time.perf_counter() - t0)

    def wrap(self, obj, method: str, name: str) -> None:
        """Record a span around every call of `obj.method` (an instance
        attribute shadows the bound method)."""
        if not self.traced:
            return
        inner = getattr(obj, method)

        def wrapped(*args, **kwargs):
            with self.span(name):
                return inner(*args, **kwargs)
        setattr(obj, method, wrapped)


# ---------------------------------------------------------------------------
# the profiler trace
# ---------------------------------------------------------------------------


def start_trace():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_trace(prof, window: str = "pb.window") -> Dict:
    """From a finished profile: the window's length (the annotation
    `window`), the seconds some device operation ran in it, device time
    and operation count by name, and the idle seconds by the innermost
    harness span open at each gap's midpoint."""
    from torch.autograd import DeviceType
    prof.__exit__(None, None, None)
    events = prof.profiler.kineto_results.events()
    device, spans, win = [], [], None
    for e in events:
        annotation = e.name().startswith("pb.") or e.is_user_annotation()
        if e.device_type() == DeviceType.CUDA and not annotation:
            device.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.device_type() != DeviceType.CUDA and e.name().startswith("pb."):
            if e.name() == window:
                win = (e.start_ns(), e.end_ns())
            else:
                spans.append((e.start_ns(), e.end_ns(), e.name()[3:]))
    if win is None:
        raise RuntimeError("the trace holds no window annotation")
    w0, w1 = win
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in device
              if e > w0 and s < w1]
    busy = _merge([(s, e) for s, e, _ in inside])
    by_name: Dict[str, List[float]] = {}
    for s, e, n in inside:
        rec = by_name.setdefault(n, [0, 0.0])
        rec[0] += 1
        rec[1] += (e - s) / 1e9
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    spans.sort()
    nxt, open_spans = 0, []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        while nxt < len(spans) and spans[nxt][0] <= mid:
            open_spans.append(spans[nxt])
            nxt += 1
        open_spans = [sp for sp in open_spans if sp[1] >= mid]
        # the innermost span: the one that started last
        label = open_spans[-1][2] if open_spans else "outside any span"
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e9
    return {"window_s": (w1 - w0) / 1e9,
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "ops": by_name, "idle_by_span": gaps}


def breakdown(trace: Dict) -> Dict:
    ops = sorted(trace["ops"].items(), key=lambda kv: -kv[1][1])[:10]
    gaps = sorted(trace["idle_by_span"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], t] for n, (_, t) in ops],
            "idle_gaps": [[n, t] for n, t in gaps]}


def kernel_device_time(trace: Dict, pattern) -> tuple:
    """(seconds, operations) of the trace's device operations whose names
    match the compiled regex `pattern`."""
    secs, count = 0.0, 0
    for name, (n, t) in trace["ops"].items():
        if pattern.search(name):
            secs += t
            count += n
    return secs, count


# ---------------------------------------------------------------------------
# per-layer metrics
# ---------------------------------------------------------------------------


def read_per_layer(cell: Dict, ctx: Dict) -> Dict:
    """Each of the cell's per-layer metrics that its reader finds something
    to read: {name: {"value", "unit"}}."""
    out = {}
    for m in cell["per_layer"]:
        base, _, suffix = m["name"].partition(".")
        reader = importlib.import_module(f"portbench.metrics.{base}")
        value = reader.read(ctx, suffix)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------


def percentile(values, p: float) -> float:
    """The p-th percentile (0-100) by linear interpolation."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    k = (len(xs) - 1) * p / 100.0
    lo = int(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def device_info(count: int) -> Dict:
    """The card's name, the count used, the peak of the fullest card since
    the window's start (run.py resets it after set-up) and its power limit
    (nvidia-smi, when it answers)."""
    import subprocess
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(count))}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.split("\n")[0]
        info["power_limit"] = out.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


def checks_correct(checks: Dict[str, Dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def print_checks(checks: Dict[str, Dict]) -> None:
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
