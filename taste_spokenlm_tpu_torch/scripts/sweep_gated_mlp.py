"""Time the gated int8 / int4 MLP kernels and the int8 / int4 FFNs that
run on them under candidate plans at the path's shapes, the timings
`kernels/fused_mlp.py:gated_plan` is set from.

For each kernel and shape (the gated MLPs at the S3-stack and Llama decode
steps, M = 1, and the Llama prefill, M = 42; `ffn_int8` and `ffn_int4` at
the S3 stack's decode step, its 131-row prefill and 40 rows) it prints one
JSON line: the
median device microseconds of a call (CUDA events after a device sleep, 20 calls after 3
of warm-up, as chip_smoke.py times a kernel) under every candidate plan
(cluster, cols, slots) the kernel takes, and the plan that `gated_plan`
picks.  M = 1 tries the one-row SIMT kernel over clusters and slot counts
and the tensor-core kernel; more rows the tensor-core kernel over clusters
and column widths.  A candidate replaces `fused_mlp.gated_plan` while it is
timed.  Weights are fan-in scaled random floats through the port's
quantizers, seeded.

`--variant NAME=4,8` times the int8 kernels with each value in place of a
compile-time constant of csrc/gated_mlp.cuh (`constexpr int NAME = ...;`,
e.g. STAGES, the ring depth): each in a process of its own (a library's
static state is shared by every copy of it that one process loads), on a
fused_mlp library built from a copy of csrc/ (scripts/_variant.py) and
loaded in place of the port's.  Compare the lines of one call only.

Usage (needs a CUDA device): python -m
taste_spokenlm_tpu_torch.scripts.sweep_gated_mlp [--kernels ffn_int8,...]
[--variant STAGES=4,8] [--out lines.jsonl]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch

from taste_spokenlm_tpu_torch import quant
from taste_spokenlm_tpu_torch.kernels import _build, fused_mlp, int4_matmul
from taste_spokenlm_tpu_torch.scripts._variant import held, load_variant

SHAPES = ((1, 1024, 2048), (1, 2048, 8192), (42, 2048, 8192))
FFN_SHAPES = ((1, 1024, 2048), (131, 1024, 2048), (40, 1024, 2048))
KERNELS = ("gated_mlp_int8", "gated_mlp_int4", "ffn_int8", "ffn_int4")
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated, of " + ", ".join(KERNELS))
    ap.add_argument("--out", default="",
                    help="also append each JSON line to this file")
    ap.add_argument("--variant", default="",
                    help="NAME=v1,v2,...: a constant of csrc/gated_mlp.cuh")
    ap.add_argument("--one", default="", help=argparse.SUPPRESS)  # a child
    opts = ap.parse_args(argv)
    kernels = opts.kernels.split(",")
    if opts.variant:
        name, values = opts.variant.split("=")
        for v in values.split(","):
            subprocess.run([sys.executable, "-m", __spec__.name, "--kernels",
                            opts.kernels, "--one", f"{name}={v}", "--out",
                            opts.out], check=True)
        return
    constants = {}
    if opts.one:
        name, value = opts.one.split("=")
        constants = {name: int(value), "held": held("fused_mlp", name)}
        _build._LIBS["fused_mlp"] = load_variant(
            "fused_mlp", {name: int(value)}, fused_mlp._SIGNATURE)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_gated_mlp: needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = _build.sm_count(dev)

    def weights(n_in, n_out):
        return torch.randn(n_in, n_out, generator=gen, device=dev) \
            * n_in ** -0.5

    def report(name, shape, us, chosen):
        line = json.dumps({"kernel": name, "shape": list(shape),
                           "device": torch.cuda.get_device_name(0),
                           "plan_us": us, "gated_plan": list(chosen),
                           **({"variant": constants} if constants else {})})
        print(line, flush=True)
        if opts.out:
            with open(opts.out, "a") as f:
                f.write(line + "\n")

    for m, h, i in FFN_SHAPES if {"ffn_int8", "ffn_int4"} & set(kernels) \
            else ():
        x = torch.randn(m, h, generator=gen, device=dev).to(torch.bfloat16)
        b1 = 0.1 * torch.randn(i, generator=gen, device=dev)
        b2 = 0.1 * torch.randn(h, generator=gen, device=dev)
        tile = fused_mlp.mlp_tile(i)
        if "ffn_int8" in kernels:
            (w1, s1), (w2, s2) = ((d["base_q"], d["base_scale"]) for d in (
                quant.quantize_kernel(weights(*shape))
                for shape in ((h, i), (i, h))))
            ffn = (w1, s1, b1, w2, s2, b2)
            us = {str(plan): time_plan(plan, fused_mlp.ffn_int8, x, ffn)
                  for plan in candidates(m)}
            report("ffn_int8", (m, h, i), us,
                   fused_mlp.gated_plan(m, h, i, sms))
        if "ffn_int4" in kernels:
            w1, s1 = int4_matmul.quantize_int4(weights(h, i))
            w2, s2 = fused_mlp.quantize_int4_tiled(weights(i, h), tile)
            ffn = (w1, s1, b1, w2, s2, b2)
            us = {str(plan): time_plan(plan, fused_mlp.ffn_int4, x, ffn)
                  for plan in candidates(m)}
            report("ffn_int4", (m, h, i), us,
                   fused_mlp.gated_plan(m, h, i, sms, tile))
    for m, h, i in SHAPES:
        if not {"gated_mlp_int8", "gated_mlp_int4"} & set(kernels):
            break
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
            if name not in kernels:
                continue
            us = {str(plan): time_plan(plan, fn, x, args)
                  for plan in candidates(m)}
            report(name, (m, h, i), us,
                   fused_mlp.gated_plan(m, h, i, sms, tile if int4 else None))


if __name__ == "__main__":
    main()
