"""The tied int8 Llama head at decode: the fused-convert formulation, the
int8 table kernel and the int4 head, each timed as a loop of `steps` steps.

Counterpart of the JAX repo's scripts/profile_lmhead.py.  At Llama-1B
shapes (V = 128,256, D = 2048, M = 1) it times a loop of
logits = (h @ table^T) * scale, the table stored int8, in three heads:

  xla fused-convert   h.bf16 @ table.bf16^T with f32 sums, times the scale
                      (XLA fuses the convert into the product; PyTorch
                      runs it as its own kernel before cuBLAS)
  int8 kernel         logits_int8 on the table as it is
  int4 head           matmul_int4 on (table * scale)^T quantized to int4

Each step feeds max(logits) * 1e-3 back into h, so the steps chain, and
takes the argmax, as the JAX loop body does.  Each head prints the JAX line
(ms a call, ms a step, GB/s of the int8 table a step), the share of its own
bytes' HBM bound that the CUDA graph reached, and the eager wall; then the
first step's parity of the int8 and int4 heads against the fused-convert
head (rel err of max|logit|, argmax agreement).

Usage: python -m taste_spokenlm_tpu_torch.scripts.profile_lmhead
       [--v 128256 --d 2048 --m 1 --steps 64] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from taste_spokenlm_tpu_torch.device import resolve_device
from taste_spokenlm_tpu_torch.kernels import int4_matmul, int8_matmul
from taste_spokenlm_tpu_torch.scripts._loop import (line, summary, tensor_bytes,
                                                    timed_loop)

BF16 = torch.bfloat16
ITERS = 3                  # timed calls of each loop, as the JAX script


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 operands with f32 sums and an f32 result, as XLA's dot
    with preferred_element_type=f32 (cuBLAS on CUDA)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def make_weights(v: int, d: int, m: int, device):
    """The JAX script's table, scales and h0 (np.random.RandomState(0)) and
    the int4 head quantized from the dequantized table, transposed.  ->
    (table [V, D] int8, scale [V] f32, h0 [M, D] bf16, (packed, scales))."""
    r = np.random.RandomState(0)
    table = torch.from_numpy(r.randint(-127, 128, (v, d)).astype(np.int8)
                             ).to(device)
    scale = torch.from_numpy((np.abs(r.randn(v)) * 0.01 + 0.005
                              ).astype(np.float32)).to(device)
    h0 = torch.from_numpy(r.randn(m, d) * 0.1).to(device, BF16)
    q4 = int4_matmul.quantize_int4(
        (table.float() * scale[:, None]).T.contiguous())
    return table, scale, h0, q4


def xla_head(h, ws):
    table, scale = ws
    return mm_f32(h.to(BF16), table.to(BF16).T) * scale[None, :]


def int8_head(h, ws):
    return int8_matmul.logits_int8(h, *ws)


def int4_head(h, ws):
    return int4_matmul.matmul_int4(h, *ws)


def loop_step(head):
    """The JAX scan body: logits of h; h + max(logits) * 1e-3 feeds the
    next step; the argmax is the step's token."""
    def step(h, ws):
        logits = head(h, ws)
        torch.argmax(logits, dim=-1)
        return h + (logits.amax(dim=-1, keepdim=True) * 1e-3).to(h.dtype)
    return step


def parity(ref: torch.Tensor, got: torch.Tensor) -> dict:
    """The JAX script's parity of got against ref (rel err of max|ref|,
    argmax agreement), with the max abs error and ref's smallest top-2
    gap over the rows (argmax agreement means something where that gap
    exceeds twice the error)."""
    err = (ref - got).abs().max().item()
    top2 = ref.topk(2, dim=-1).values
    return {"rel_err": err / (ref.abs().max().item() + 1e-9),
            "max_abs_err": err,
            "argmax_agree": (ref.argmax(-1) == got.argmax(-1)).float()
            .mean().item(),
            "ref_top2_gap": (top2[..., 0] - top2[..., 1]).min().item()}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--v", type=int, default=128256)
    ap.add_argument("--d", type=int, default=2048)
    ap.add_argument("--m", type=int, default=1)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    V, D, M, S = args.v, args.d, args.m, args.steps
    table, scale, h0, q4 = make_weights(V, D, M, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = {"device": dev.type, "v": V, "d": D, "m": M, "steps": S,
           "heads": {}}
    heads = (("xla fused-convert", "xla", xla_head, (table, scale)),
             ("int8 kernel", "int8", int8_head, (table, scale)),
             ("int4 head", "int4", int4_head, q4))
    for name, key, head, ws in heads:
        res = timed_loop(loop_step(head), h0, ws, S, ITERS, delta=1e-3)
        s = summary(res, S, tensor_bytes(ws), min)
        print(line(name, s, V * D / (s["ms_per_step"] / 1e3) / 1e9),
              flush=True)
        out["heads"][key] = {"name": name, **s}
    # correctness cross-check on the first step
    a = xla_head(h0, (table, scale))
    for key, got in (("int8", int8_head(h0, (table, scale))),
                     ("int4", int4_head(h0, q4))):
        out["heads"][key]["calls"] += 1
        p = parity(a, got)
        out[f"parity_{key}"] = p
        print(f"parity {key}: rel err {p['rel_err']:.2e}, argmax agree "
              f"{p['argmax_agree']:.3f}", flush=True)
    if dev.type == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


if __name__ == "__main__":
    main()
