"""The program's own spans and counters (`taste_spokenlm_tpu_torch/utils/
profiling.py`) on the device trace's clock, and the per-layer metrics read
from them.

    python3 -m portbench.program_trace --workload <cell> --seed <n> \
        --seconds <s>

runs the cell as `python3 -m portbench.run ... --trace 1` does (the same
set-up, window, profiler and check, through `run.run_cell`), with the
program's tracer on from before set-up.  It prints run.py's result line
with the cell's metrics of `METRICS` added, and on standard error the
device time and the idle time by innermost program span and the device
time of the copy kernels by innermost program span.  The benchmark's own
runs do not run it: `BENCHMARK.json` names none of these metrics, since
the harness's run.py and entries would have to turn the tracer on
(PERF.md §7).

The clock.  The profiler stamps its events on the Unix-epoch clock, the
tracer its spans on `time.perf_counter_ns()`.  An anchor is a
`record_function` marker with a `perf_counter_ns()` reading taken inside
it; the offset between the clocks is the marker's midpoint less the
reading, from the narrowest of a few anchors taken as the window opens
and again as it closes, and moves straight from one to the other over
the window (`Clock`).  Device operations are mapped onto the program's
clock.

Attribution.  A device operation belongs to the innermost program span
open when it was launched: its correlation id leads to the runtime call
that launched it (cudaLaunchKernel, cudaMemcpyAsync, ...), whose time and
thread pick the span (by time alone across the program's threads when the
launch's thread is not one the tracer saw).  Kineto names a thread by its
native id or by its pthread id cut to 32 bits (torch 2.11 on the H100;
`kineto_threads`).  An idle gap of the device belongs to the innermost
spans open at its midpoint, one per thread.
"""

from __future__ import annotations

import bisect
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from typing import Dict, Iterable, List, Optional, Sequence, Tuple  # noqa: E402

from portbench.common import _merge as merge  # noqa: E402

ANCHOR = "pt.anchor"
WINDOW = "pb.window"
NO_SPAN = "outside any program span"
NO_LAUNCH = "no launch event"
COPIES = re.compile(r"elementwise|copy|Memcpy|Memset", re.I)

# the per-layer metrics a traced run with the tracer on gives, by cell:
# (name, unit); each is read by portbench/metrics/<base>.py
METRICS = {
    "recon-batch": [("recon_s3_live_row_share", "%"),
                    ("recon_s3_sync_ms_per_step", "ms"),
                    ("recon_s3_step_device_ms", "ms"),
                    ("setup_program_s.recon", "s")],
    "tokenize-serve": [("tokenize_lock_wait_ms_p95", "ms"),
                       ("tokenize_service_ms_p50", "ms"),
                       ("tokenize_service_idle_share", "%"),
                       ("setup_program_s.tokenize", "s")],
    "stage1-train": [("train_opt_idle_ms", "ms"),
                     ("setup_program_s.train", "s")],
}
SETUP_SPANS = ("setup.construct", "setup.serving_layout", "kernels.load")


# ---------------------------------------------------------------------------
# the clock
# ---------------------------------------------------------------------------


def take_anchors(tag: str, n: int = 5) -> List[int]:
    """`n` anchors in the running profile: marker `pt.anchor.<tag>.<k>`
    holds the k-th reading of `perf_counter_ns()`."""
    import torch
    out = []
    for k in range(n):
        with torch.profiler.record_function(f"{ANCHOR}.{tag}.{k}"):
            out.append(time.perf_counter_ns())
    return out


def anchor_offset(marks: Dict[str, Tuple[int, int]], tag: str,
                  readings: Sequence[int]) -> Tuple[int, int]:
    """(program ns, profiler ns less program ns) at the narrowest of the
    anchors `tag`."""
    best = None
    for k, ns in enumerate(readings):
        s, e = marks[f"{ANCHOR}.{tag}.{k}"]
        if best is None or e - s < best[0]:
            best = (e - s, ns, (s + e) // 2 - ns)
    if best is None:
        raise RuntimeError(f"the trace holds no anchor {tag!r}")
    return best[1], best[2]


class Clock:
    """Profiler ns -> program ns from anchors (program ns, offset): the
    offset of the first, moving straight to that of the last between them
    (the clocks drift apart over a window), held past either end."""

    def __init__(self, *points: Tuple[int, int]):
        self.first, self.last = min(points), max(points)

    @property
    def drift(self) -> int:
        return self.last[1] - self.first[1]

    def __call__(self, t: int) -> int:
        (p0, o0), (p1, o1) = self.first, self.last
        f = 0.0 if p1 == p0 else min(max((t - o0 - p0) / (p1 - p0), 0.0),
                                     1.0)
        return t - o0 - round(f * (o1 - o0))


# ---------------------------------------------------------------------------
# the profiler's events
# ---------------------------------------------------------------------------


def _is_launch(name: str) -> bool:
    """A CUDA API call (`cuda*` or `cu*`) that puts work on the device."""
    return name.startswith("cu") and ("Launch" in name or "Memcpy" in name
                                      or "Memset" in name)


def extract(events) -> Dict:
    """From kineto's events: device operations (start, end, correlation,
    name), launches {correlation: (time, thread)}, and markers {name:
    (start, end)} (the window and the anchors), all in profiler ns.  The
    same filter as common.read_trace: a user annotation is no device
    operation."""
    from torch.autograd import DeviceType
    ops, launches, marks = [], {}, {}
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not (name.startswith("pb.") or e.is_user_annotation()):
                ops.append((e.start_ns(), e.end_ns(), e.correlation_id(),
                            name))
        elif name == WINDOW or name.startswith(ANCHOR):
            marks[name] = (e.start_ns(), e.end_ns())
        elif _is_launch(name):
            launches[e.correlation_id()] = (e.start_ns(),
                                            e.device_resource_id())
    return {"ops": ops, "launches": launches, "marks": marks}


def kineto_threads(threads: Dict[int, int]) -> Dict[int, int]:
    """Kineto's id of the thread of a runtime call -> the tracer's
    (`threading.get_ident()`), from the tracer's {ident: native id}: kineto
    gives a thread's native id or its pthread id cut to 32 bits."""
    out = {i & 0xFFFFFFFF: i for i in threads}
    out.update({native: i for i, native in threads.items()})
    return out


# ---------------------------------------------------------------------------
# intervals
# ---------------------------------------------------------------------------


def overlap(a: List[List[int]], b: List[List[int]]) -> int:
    """The length two merged, sorted interval lists share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


# ---------------------------------------------------------------------------
# the program's trace on one clock
# ---------------------------------------------------------------------------


class ProgramTrace:
    """The tracer's spans (`utils/profiling.Span`) and the window's
    counters, with the profiler's device operations mapped onto the
    program's clock by `clock` (a `Clock`) and their launches' threads by
    `threads` (kineto's id -> the tracer's).  `window` is (start, end) on
    the program's clock."""

    def __init__(self, spans: Sequence, counters: Dict[str, int],
                 trace: Dict, clock: Clock,
                 threads: Optional[Dict[int, int]] = None):
        self.spans = list(spans)
        self.counters = dict(counters)
        self.by_id = {s.id: s for s in self.spans}
        w0, w1 = trace["marks"][WINDOW]
        self.window = (clock(w0), clock(w1))
        self._threads: Dict[int, Tuple[List[int], List]] = {}
        # a parent before a child that started on the same ns
        for s in sorted(self.spans, key=lambda s: (s.start_ns, -s.end_ns)):
            starts, seq = self._threads.setdefault(s.thread, ([], []))
            starts.append(s.start_ns)
            seq.append(s)
        # device operations in the window: (start, end, name, span or None,
        # launch time or None)
        self.ops = []
        self.by_thread = 0
        for s, e, corr, name in trace["ops"]:
            s, e = clock(s), clock(e)
            if e <= self.window[0] or s >= self.window[1]:
                continue
            s, e = max(s, self.window[0]), min(e, self.window[1])
            launch = trace["launches"].get(corr)
            span = None
            if launch is not None:
                t = clock(launch[0])
                thread = (threads or {}).get(launch[1], launch[1])
                span = self.innermost(t, thread)
                self.by_thread += thread in self._threads
            self.ops.append((s, e, name, span,
                             None if launch is None else t))
        self.busy = merge((s, e) for s, e, *_ in self.ops)

    # -- lookups ------------------------------------------------------------

    def _on_thread(self, t: int, thread: int):
        starts, seq = self._threads[thread]
        i = bisect.bisect_right(starts, t) - 1
        s = seq[i] if i >= 0 else None
        while s is not None and s.end_ns < t:
            s = self.by_id.get(s.parent)
        return s

    def innermost(self, t: int, thread: Optional[int] = None):
        """The innermost span open at `t` on `thread`; on any thread (the
        latest started) when the tracer never saw `thread`."""
        if thread in self._threads:
            return self._on_thread(t, thread)
        found = [s for s in (self._on_thread(t, th) for th in self._threads)
                 if s is not None]
        return max(found, key=lambda s: s.start_ns) if found else None

    def under(self, span, name: str) -> bool:
        """Whether `span` is `name` or lies inside a span `name`."""
        while span is not None:
            if span.name == name:
                return True
            span = self.by_id.get(span.parent)
        return False

    def named(self, name: str, window: bool = True) -> List:
        """The spans `name` that started in the window (`window`), or ended
        before it (not `window`)."""
        w0, w1 = self.window
        return [s for s in self.spans if s.name == name
                and (w0 <= s.start_ns <= w1 if window else s.end_ns <= w0)]

    # -- the numbers ----------------------------------------------------------

    def idle_within(self, spans: Sequence) -> Tuple[int, int]:
        """(ns in which no device operation ran, ns) within the union of
        `spans`, clipped to the window."""
        w0, w1 = self.window
        union = merge((max(s.start_ns, w0), min(s.end_ns, w1))
                      for s in spans if s.end_ns > w0 and s.start_ns < w1)
        total = sum(e - s for s, e in union)
        return total - overlap(union, self.busy), total

    def device_ns_under(self, name: str) -> int:
        return sum(e - s for s, e, _, span, _ in self.ops
                   if self.under(span, name))

    def ops_before_their_span(self, name: str) -> Tuple[int, int]:
        """(count, the most ns by which one leads) of the device operations
        launched inside a span `name` that started before that span did
        (none when the clocks agree)."""
        bad = lead = 0
        for s, _, _, span, _ in self.ops:
            while span is not None and span.name != name:
                span = self.by_id.get(span.parent)
            if span is not None and s < span.start_ns:
                bad, lead = bad + 1, max(lead, span.start_ns - s)
        return bad, lead

    def launch_lag_by_tenth(self) -> List[List[float]]:
        """For each tenth of the window by launch time: [the least, the
        median] of (device start - launch) in us, and the share (%) of
        operations that start before their launch."""
        w0, w1 = self.window
        lags: List[List[int]] = [[] for _ in range(10)]
        for s, _, _, _, t in self.ops:
            if t is not None and w0 <= t < w1:
                lags[min(9, (t - w0) * 10 // (w1 - w0))].append(s - t)
        out = []
        for x in lags:
            x.sort()
            out.append([x[0] / 1e3, x[len(x) // 2] / 1e3,
                        100.0 * sum(v < 0 for v in x) / len(x)] if x else [])
        return out

    def ops_before_launch(self) -> Tuple[int, int]:
        """(count, the most ns by which one leads) of the device operations
        that start before the runtime call that launched them: the
        profiler's own disagreement between the device's and the host's
        clocks."""
        bad = lead = 0
        for s, _, _, _, t in self.ops:
            if t is not None and s < t:
                bad, lead = bad + 1, max(lead, t - s)
        return bad, lead

    # -- breakdowns ------------------------------------------------------------

    def device_by_span(self, pattern=None) -> Dict[str, float]:
        """Device seconds by innermost span name (of the operations whose
        name matches `pattern`, when given)."""
        out: Dict[str, float] = {}
        for s, e, name, span, t in self.ops:
            if pattern is not None and not pattern.search(name):
                continue
            label = span.name if span is not None else (
                NO_SPAN if t is not None else NO_LAUNCH)
            out[label] = out.get(label, 0.0) + (e - s) / 1e9
        return out

    def idle_by_span(self) -> Dict[str, float]:
        """Idle seconds of the window by the innermost spans open at each
        gap's midpoint, one per thread, names joined by '+'."""
        out: Dict[str, float] = {}
        w0, w1 = self.window
        edges = [w0] + [x for iv in self.busy for x in iv] + [w1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            names = sorted({s.name for s in (self._on_thread(mid, th)
                                             for th in self._threads)
                            if s is not None})
            label = "+".join(names) or NO_SPAN
            out[label] = out.get(label, 0.0) + (b - a) / 1e9
        return out


# ---------------------------------------------------------------------------
# the tool
# ---------------------------------------------------------------------------


def read_metrics(cell_name: str, ctx: Dict) -> Dict:
    out = {}
    for name, unit in METRICS.get(cell_name, []):
        base, _, suffix = name.partition(".")
        value = importlib.import_module(f"portbench.metrics.{base}").read(
            ctx, suffix)
        if value is not None:
            out[name] = {"value": value, "unit": unit}
    return out


def _top(d: Dict[str, float], n: int) -> List:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


@contextlib.contextmanager
def _capturing(common, profiling, got: Dict):
    """run.run_cell's profiler with anchors taken and the counters read as
    the window opens, and its events kept when the trace is read."""
    start, read = common.start_trace, common.read_trace

    def start_trace():
        prof = start()
        got["start"] = take_anchors("start")
        got["counters0"] = profiling.counters()
        return prof

    def read_trace(prof, *args, **kwargs):
        got["end"] = take_anchors("end")
        summary = read(prof, *args, **kwargs)
        got["counters1"] = profiling.counters()
        got["trace"] = extract(prof.profiler.kineto_results.events())
        return summary
    common.start_trace, common.read_trace = start_trace, read_trace
    try:
        yield
    finally:
        common.start_trace, common.read_trace = start, read


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from portbench import run
    run._environment(os.getcwd())
    import torch
    from taste_spokenlm_tpu_torch.utils import profiling

    from portbench import common
    cell = common.cell_spec(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s)", file=sys.stderr)
        return 3
    got: Dict = {}
    profiling.reset()
    profiling.enable()
    with _capturing(common, profiling, got):
        result = run.run_cell(cell, args.seed, args.seconds, True, "cuda",
                              T_START)
    profiling.disable()
    c0, c1 = got["counters0"], got["counters1"]
    counters = {k: v - c0.get(k, 0) for k, v in c1.items()}
    spans, marks = profiling.spans(), got["trace"]["marks"]
    clock = Clock(*(anchor_offset(marks, tag, got[tag])
                    for tag in ("start", "end")))
    pt = ProgramTrace(spans, counters, got["trace"], clock,
                      kineto_threads(profiling.threads()))
    result["metrics"].update(read_metrics(args.workload, {"program": pt}))
    print(json.dumps({
        "program_spans": len(pt.spans), "counters": counters,
        "clock_drift_ns": clock.drift,
        "setup_s_by_span": {n: sum(s.end_ns - s.start_ns for s in
                                   pt.named(n, window=False)) / 1e9
                            for n in SETUP_SPANS},
        "device_ops": len(pt.ops),
        "launch_found": sum(o[4] is not None for o in pt.ops),
        "ops_before_launch": pt.ops_before_launch(),
        "launch_lag_us_by_tenth": pt.launch_lag_by_tenth(),
        "launch_thread_seen": pt.by_thread,
        "s3_step_ops_before_span": pt.ops_before_their_span("s3.step"),
        "device_s_by_span": _top(pt.device_by_span(), 15),
        "idle_s_by_span": _top(pt.idle_by_span(), 15),
        "copy_s_by_span": _top(pt.device_by_span(COPIES), 15)}),
        file=sys.stderr, flush=True)
    common.print_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
