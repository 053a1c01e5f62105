"""A decode loop timed as the JAX scripts time theirs, and as the port
serves.

The JAX scripts jit a `lax.scan` of `steps` decode steps and time one call
of it: the device runs the whole loop with no host in between.  PyTorch's
counterpart is a CUDA graph: `timed_loop` captures `steps` calls of the
step into one `torch.cuda.CUDAGraph` and replays it.  Beside it, it times
the same loop eagerly, one Python dispatch per kernel, which is how the
port's serving paths run; the gap between the two walls is the host's
share of a decode step.

Launch counters (`kernels.launch_counts()`) move when a wrapper runs: in
the warm-up, at capture and in eager calls, never at replay.  So the
launches of one loop are read from one eager call.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Optional

import torch

from taste_spokenlm_tpu_torch.kernels import launch_counts

# NVIDIA H100 SXM data sheet: HBM3 bytes/s
HBM_BPS = 3.35e12
WARMUP = 2                  # step calls on a side stream before capture
EAGER_ITERS = 2             # timed eager loops; the first one's launches count


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nest of lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(t) for t in tree)
    return 0


def _run(step: Callable, x: torch.Tensor, ws, steps: int) -> torch.Tensor:
    for _ in range(steps):
        x = step(x, ws)
    return x


def _readback(x: torch.Tensor) -> float:
    return float(x.float().sum())


def timed_loop(step: Callable, x0: torch.Tensor, ws, steps: int, iters: int,
               delta: float = 1e-6) -> dict:
    """Time `steps` chained calls x = step(x, ws) from x0.

    On CUDA: warm the step up on a side stream, capture the loop into one
    CUDA graph, then `iters` timed calls, each copying x0 + (i + 1) * delta
    into the graph's static input, replaying it and reading back a sum on
    the host.  On either device: EAGER_ITERS timed eager calls of the same
    loop on the same varied inputs; the first one's launch counts are the
    loop's.  -> {"graph_walls": [s] (None on the CPU), "eager_walls": [s],
    "launches": {kernel: launches of one loop}, "calls": step calls made
    through the wrappers (warm-up, capture, eager)}."""
    dev = x0.device
    graph_walls: Optional[list] = None
    calls = 0
    if dev.type == "cuda":
        static_x = x0.clone()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                step(static_x, ws)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = _run(step, static_x, ws, steps)
        calls += WARMUP + steps
        graph_walls = []
        for i in range(iters):
            xi = x0 + (i + 1) * delta
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            static_x.copy_(xi)
            graph.replay()
            _readback(static_out)
            graph_walls.append(time.perf_counter() - t0)
        del graph, static_out, static_x
    eager_walls, launches = [], {}
    for i in range(EAGER_ITERS):
        xi = x0 + (i + 1) * delta
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        before = launch_counts()
        t0 = time.perf_counter()
        _readback(_run(step, xi, ws, steps))
        eager_walls.append(time.perf_counter() - t0)
        if i == 0:
            after = launch_counts()
            launches = {k: after[k] - before[k] for k in after
                        if after[k] != before[k]}
        calls += steps
    return {"graph_walls": graph_walls, "eager_walls": eager_walls,
            "launches": launches, "calls": calls}


def summary(res: dict, steps: int, n_bytes: int, stat=statistics.median
            ) -> dict:
    """Per-call and per-step walls of a timed_loop result (the graph's on
    CUDA, the eager loop's on the CPU), the HBM byte bound of `n_bytes` a
    step and, on CUDA, the share of it that the graph reached."""
    graph = res["graph_walls"] is not None
    wall = stat(res["graph_walls"] if graph else res["eager_walls"])
    eager = statistics.median(res["eager_walls"])
    bound_ms = n_bytes / HBM_BPS * 1e3
    return {"timed": "cuda graph" if graph else "eager, cpu",
            "ms_per_call": wall * 1e3, "ms_per_step": wall / steps * 1e3,
            "eager_ms_per_call": eager * 1e3,
            "eager_ms_per_step": eager / steps * 1e3,
            "bytes_per_step": n_bytes, "bound_ms_per_step": bound_ms,
            "bound_share": bound_ms / (wall / steps * 1e3) if graph else None,
            "walls_s": res["graph_walls"], "eager_walls_s": res["eager_walls"],
            "launches": res["launches"], "calls": res["calls"]}


def line(name: str, s: dict, gb_s: float) -> str:
    """The JAX script's line (ms a call, ms a step, GB/s), the share of the
    HBM byte bound (CUDA only), and the eager wall."""
    share = ("bound: not measured" if s["bound_share"] is None
             else f"{s['bound_share']:6.1%} of the byte bound")
    return (f"{name:20s} {s['ms_per_call']:8.1f} ms/call  "
            f"{s['ms_per_step']:6.3f} ms/step  {gb_s:6.0f} GB/s  "
            f"{share} ({s['timed']})  "
            f"eager {s['eager_ms_per_call']:8.1f} ms/call  "
            f"{s['eager_ms_per_step']:6.3f} ms/step")
