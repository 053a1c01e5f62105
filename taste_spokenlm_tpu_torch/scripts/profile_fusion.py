"""Decode-layout study: the B = 1 decode GEMVs of a synthetic Llama-1B
stack (or, with --s3, the 7-block S3 conformer stack) in seven weight
layouts, each timed as a loop of `steps` decode steps.

Counterpart of the JAX repo's scripts/profile_fusion.py, one-to-one:

  A separate        per layer q, k, v, o, gate, up, down: 7 GEMVs
  B fused           fused qkv and gate-up: 4 GEMVs
  P int8 kernel     B's weights through matmul_int8, one call a projection
  Q int4 kernel     fused projections through matmul_int4
  R fused-MLP int8  B's qkv / o as GEMVs, the MLP through gated_mlp_int8
  S fused-MLP int4  qkv / o through matmul_int4, the MLP through
                    gated_mlp_int4 (down projection packed per 512 rows)
  C giant           every layer's weights as one [H, sum] read: the
                    bandwidth bound, with no meaning as a model

A GEMV is the XLA formulation, (x.bf16 @ w.bf16) * s.bf16.  In PyTorch the
int8 -> bf16 convert is its own kernel, not fused into the product as XLA
fuses it.  The weights follow the JAX recipe: int8 in [-127, 127], scales
(U + 0.5) / 127, made on the device from a generator seeded 0; int4 from
the same int8 grid times 0.02 / 64.  With them x grows by orders of
magnitude a layer and leaves the bf16 range within a few layers, so the
timed loop computes inf / NaN.  The time of these GEMVs does not depend on
the values; correctness is held elsewhere, on one layer.

Each layout prints the JAX line (ms a call, ms a step, GB/s of the int8
stack a step), the share of its own weight bytes' HBM bound that the CUDA
graph reached, and the eager wall.

Usage: python -m taste_spokenlm_tpu_torch.scripts.profile_fusion
       [--s3] [--only B,P] [--iters 20] [--device cpu]
"""

from __future__ import annotations

import argparse
import statistics
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from taste_spokenlm_tpu_torch.device import resolve_device
from taste_spokenlm_tpu_torch.kernels import fused_mlp, int4_matmul, int8_matmul
from taste_spokenlm_tpu_torch.scripts._loop import (line, summary, tensor_bytes,
                                                    timed_loop)

KERNELS = {"matmul_int8": int8_matmul.matmul_int8,
           "matmul_int4": int4_matmul.matmul_int4,
           "gated_mlp_int8": fused_mlp.gated_mlp_int8,
           "gated_mlp_int4": fused_mlp.gated_mlp_int4}
PLAIN = {"matmul_int8": int8_matmul.matmul_int8_plain,
         "matmul_int4": int4_matmul.matmul_int4_plain,
         "gated_mlp_int8": fused_mlp.gated_mlp_int8_plain,
         "gated_mlp_int4": fused_mlp.gated_mlp_int4_plain}
DOWN_TILE = 512            # rows per tile of S's packed down projection
LAYOUTS = (("A", "A separate", "a"), ("B", "B fused", "b"),
           ("P", "P int8 kernel", "b"), ("Q", "Q int4 kernel", "q"),
           ("R", "R fusedmlp-i8", "r"), ("S", "S fusedmlp-i4", "s"),
           ("C", "C giant", "c"))
BF16 = torch.bfloat16


def gemv(x, w, s):
    return (x.to(BF16) @ w.to(BF16)) * s.to(BF16)


def _attn(q, k, v):
    """The stand-in attention of the JAX steps: q + pad(k + v)."""
    return q + F.pad(k + v, (0, q.shape[-1] - k.shape[-1]))


def _qkv(qkv, h: int):
    kv = (qkv.shape[-1] - h) // 2
    return qkv[:, :h], qkv[:, h:h + kv], qkv[:, h + kv:]


def _gu(gu):
    i = gu.shape[-1] // 2
    return gu[:, :i], gu[:, i:]


# ---- the steps: x [1, H] f32 -> x, over a list of per-layer weights ----


def step_a(x, ws, ops=KERNELS):
    for lw in ws:
        q, k, v = gemv(x, *lw[0]), gemv(x, *lw[1]), gemv(x, *lw[2])
        x = x + gemv(_attn(q, k, v), *lw[3])
        g, u = gemv(x, *lw[4]), gemv(x, *lw[5])
        x = x + gemv(F.silu(g) * u, *lw[6])
    return x


def step_b(x, ws, ops=KERNELS):
    for lw in ws:
        x = x + gemv(_attn(*_qkv(gemv(x, *lw[0]), x.shape[-1])), *lw[1])
        g, u = _gu(gemv(x, *lw[2]))
        x = x + gemv(F.silu(g) * u, *lw[3])
    return x


def _fused_step(mm):
    """B's step with every projection through the kernel `mm` (P, Q)."""
    def step(x, ws):
        for lw in ws:
            qkv = mm(x, *lw[0]).to(BF16)
            x = x + mm(_attn(*_qkv(qkv, x.shape[-1])), *lw[1]).to(BF16)
            g, u = _gu(mm(x, *lw[2]).to(BF16))
            x = x + mm(F.silu(g) * u, *lw[3]).to(BF16)
        return x
    return step


def step_p(x, ws, ops=KERNELS):
    return _fused_step(ops["matmul_int8"])(x, ws)


def step_q(x, ws, ops=KERNELS):
    return _fused_step(ops["matmul_int4"])(x, ws)


def step_r(x, ws, ops=KERNELS):
    for lw in ws:
        x = x + gemv(_attn(*_qkv(gemv(x, *lw[0]), x.shape[-1])), *lw[1])
        x = x + ops["gated_mlp_int8"](x.to(BF16), *lw[2], *lw[3], *lw[4]
                                      ).to(BF16)
    return x


def step_s(x, ws, ops=KERNELS, tile=DOWN_TILE):
    mm = ops["matmul_int4"]
    for lw in ws:
        qkv = mm(x, *lw[0]).to(BF16)
        x = x + mm(_attn(*_qkv(qkv, x.shape[-1])), *lw[1]).to(BF16)
        x = x + ops["gated_mlp_int4"](x.to(BF16), *lw[2], *lw[3], *lw[4],
                                      tile=tile).to(BF16)
    return x


def step_c(x, ws, ops=KERNELS):
    return x + gemv(x, *ws)[:, :x.shape[-1]]


STEPS = {"A": step_a, "B": step_b, "P": step_p, "Q": step_q, "R": step_r,
         "S": step_s, "C": step_c}


# ---- the weights ----


def shapes(h: int, kv: int, i: int):
    """(separate, fused) [in, out] shapes of one layer's projections."""
    return ([(h, h), (h, kv), (h, kv), (h, h), (h, i), (h, i), (i, h)],
            [(h, h + 2 * kv), (h, h), (h, 2 * i), (i, h)])


class WeightSets:
    """The layouts' weights, built lazily on `device` from one generator
    seeded `seed`, as the JAX script memoizes them: R reads B's qkv / o and
    A's gate / up / down; B concatenates A's."""

    SOURCES = {"a": (), "b": ("a",), "q": (), "r": ("a", "b"), "s": (),
               "c": ()}

    def __init__(self, h: int, kv: int, i: int, layers: int, device,
                 seed: int = 0):
        self.h, self.kv, self.i, self.layers = h, kv, i, layers
        self.sep, self.fused = shapes(h, kv, i)
        self.dev = device
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.cache: Dict[str, object] = {}

    def mk(self, d_in: int, d_out: int):
        q = torch.randint(-127, 128, (d_in, d_out), generator=self.gen,
                          device=self.dev, dtype=torch.int8)
        s = (torch.rand(d_out, generator=self.gen, device=self.dev) + 0.5) / 127.0
        return q, s

    def mk4(self, d_in: int, d_out: int, tile=None):
        w = self.mk(d_in, d_out)[0].float() * (0.02 / 64.0)
        if tile:
            return fused_mlp.quantize_int4_tiled(w, tile)
        return int4_matmul.quantize_int4(w)

    def _build(self, key: str):
        L = range(self.layers)
        if key == "a":
            return [[self.mk(*sh) for sh in self.sep] for _ in L]
        if key == "b":
            def fuse(pairs):
                return (torch.cat([w for w, _ in pairs], dim=1),
                        torch.cat([s for _, s in pairs]))
            return [[fuse(lw[0:3]), lw[3], fuse(lw[4:6]), lw[6]]
                    for lw in self.get("a")]
        if key == "q":
            return [[self.mk4(*sh) for sh in self.fused] for _ in L]
        if key == "r":
            a, b = self.get("a"), self.get("b")
            return [[b[n][0], b[n][1], a[n][4], a[n][5], a[n][6]] for n in L]
        if key == "s":
            h, kv, i = self.h, self.kv, self.i
            return [[self.mk4(h, h + 2 * kv), self.mk4(h, h), self.mk4(h, i),
                     self.mk4(h, i), self.mk4(i, h, DOWN_TILE)] for _ in L]
        per_layer = sum(a * b for a, b in self.sep)
        return self.mk(self.h, per_layer * self.layers // self.h)

    def get(self, key: str):
        if key not in self.cache:
            self.cache[key] = self._build(key)
        return self.cache[key]

    def _needed(self, key: str) -> set:
        if key in self.cache:
            return {key}
        return {key}.union(*(self._needed(k) for k in self.SOURCES[key]))

    def release(self, later: List[str]) -> None:
        """Free every set that no layout in `later` (set keys) reads or
        builds from."""
        keep = set().union(*(self._needed(k) for k in later))
        for key in list(self.cache):
            if key not in keep:
                del self.cache[key]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--layers", type=int, default=16)
    p.add_argument("--h", type=int, default=2048, help="hidden size")
    p.add_argument("--kv", type=int, default=512, help="kv proj out dim")
    p.add_argument("--i", dest="inter", type=int, default=8192,
                   help="mlp intermediate size")
    p.add_argument("--s3", action="store_true",
                   help="the S3 speech-decoder stack's decode shapes (7 "
                        "blocks, d = 1024, q / k / v / out [1024, 1024], FFN "
                        "1024 <-> 2048), 512 steps")
    p.add_argument("--only", default=None,
                   help="comma-separated layout letters to run, e.g. B,Q")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (the plain versions)")
    args = p.parse_args(argv)
    if args.s3:
        args.h, args.kv, args.inter, args.layers = 1024, 1024, 2048, 7
        args.steps = 512
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    H, L = args.h, args.layers
    sets = WeightSets(H, args.kv, args.inter, L, dev)
    gb = sum(a * b for a, b in sets.sep) * L / 1e9
    print(f"weights: {gb:.2f} GB int8; {args.steps} steps/call; device "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}",
          flush=True)
    only = set(args.only.upper().split(",")) if args.only else None
    run = [lay for lay in LAYOUTS if not only or lay[0] in only]
    r = np.random.RandomState(0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = {"device": dev.type, "steps": args.steps, "layers": L,
           "h": H, "kv": args.kv, "i": args.inter, "int8_gb": gb,
           "layouts": {}}
    for n, (letter, name, key) in enumerate(run):
        ws = sets.get(key)
        n_bytes = tensor_bytes(ws)
        x0 = torch.from_numpy(r.randn(1, H).astype(np.float32)).to(dev)
        res = timed_loop(STEPS[letter], x0, ws, args.steps, args.iters)
        s = summary(res, args.steps, n_bytes, statistics.median)
        print(line(name, s, gb / (s["ms_per_step"] / 1e3)), flush=True)
        out["layouts"][letter] = {"name": name, **s}
        del ws
        sets.release([k for _, _, k in run[n + 1:]])
    if dev.type == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        print(f"peak device memory {out['peak_mem_gb']:.2f} GB", flush=True)
    return out


if __name__ == "__main__":
    main()
