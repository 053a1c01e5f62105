"""Time the gated int8 / int4 MLP kernels under candidate plans at the
path's shapes, the timings `kernels/fused_mlp.py:gated_plan` is set from.

For each kernel and shape (the S3-stack and Llama decode steps, M = 1, and
the Llama prefill, M = 42) it prints one JSON line: the median device
microseconds of a call (CUDA events after a device sleep, 20 calls after 3
of warm-up, as chip_smoke.py times a kernel) under every candidate plan
(cluster, cols, slots) the kernel takes, and the plan that `gated_plan`
picks.  M = 1 tries the one-row SIMT kernel over clusters and slot counts
and the tensor-core kernel; M = 42 the tensor-core kernel over clusters and
column widths.  A candidate replaces `fused_mlp.gated_plan` while it is
timed.  Weights are fan-in scaled random floats through the port's
quantizers, seeded.

Usage (needs a CUDA device): python -m
taste_spokenlm_tpu_torch.scripts.sweep_gated_mlp
"""

from __future__ import annotations

import json
import statistics

import torch

from taste_spokenlm_tpu_torch import quant
from taste_spokenlm_tpu_torch.kernels import _build, fused_mlp, int4_matmul

SHAPES = ((1, 1024, 2048), (1, 2048, 8192), (42, 2048, 8192))
SIMT = ((8, 15), (8, 14), (8, 12), (4, 30), (4, 28), (4, 24), (2, 66),
        (2, 64), (2, 60))


def time_us(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


def candidates(m: int):
    plans = [(c, 128, s) for c, s in SIMT] if m == 1 else []
    return plans + [(cluster, cols, 0) for cluster in fused_mlp.GATED_CLUSTERS
                    for cols in fused_mlp.GATED_COLS]


def time_plan(plan, fn, x, args):
    """fn(x, *args) timed with `plan` in place of gated_plan's choice."""
    chosen = fused_mlp.gated_plan
    fused_mlp.gated_plan = lambda *_: plan
    try:
        return time_us(lambda: fn(x, *args))
    except (RuntimeError, ValueError) as e:     # a plan the kernel refuses
        return str(e)
    finally:
        fused_mlp.gated_plan = chosen


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_gated_mlp: needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = _build.sm_count(dev)

    def weights(n_in, n_out):
        return torch.randn(n_in, n_out, generator=gen, device=dev) \
            * n_in ** -0.5

    for m, h, i in SHAPES:
        x = torch.randn(m, h, generator=gen, device=dev).to(torch.bfloat16)
        q = [quant.quantize_kernel(weights(*shape))
             for shape in ((h, i), (h, i), (i, h))]
        args8 = [t for d in q for t in (d["base_q"], d["base_scale"])]
        tile = fused_mlp.mlp_tile(i)
        args4 = [*int4_matmul.quantize_int4(weights(h, i)),
                 *int4_matmul.quantize_int4(weights(h, i)),
                 *fused_mlp.quantize_int4_tiled(weights(i, h), tile)]
        for name, fn, args, int4 in (
                ("gated_mlp_int8", fused_mlp.gated_mlp_int8, args8, False),
                ("gated_mlp_int4", fused_mlp.gated_mlp_int4, args4, True)):
            us = {str(plan): time_plan(plan, fn, x, args)
                  for plan in candidates(m)}
            chosen = fused_mlp.gated_plan(m, h, i, sms, tile if int4 else None)
            print(json.dumps({"kernel": name, "shape": [m, h, i],
                              "device": torch.cuda.get_device_name(0),
                              "plan_us": us, "gated_plan": list(chosen)}),
                  flush=True)


if __name__ == "__main__":
    main()
