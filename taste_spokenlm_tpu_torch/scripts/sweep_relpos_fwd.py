"""Time the bf16 rel-pos forward kernel under each candidate number of
warp groups, the timing `FWD_GROUPS` in csrc/relpos_attention.cu is set
from.

A candidate is built from a copy of csrc/ in which `FWD_GROUPS` takes the
candidate's value (scripts/_variant.py), then loaded and called through its
C entry point on the stage-1 training shape (B = 8, T = 1599, H = 8, dk = 128, bf16, every row T long) and on
ragged lengths.  One JSON line a candidate: the median device milliseconds
of a call (CUDA events after a device sleep, 20 calls after 3 of warm-up, as
chip_smoke.py times a kernel), o's error against
`relpos_causal_attention_plain` relative to max|plain| and the LSE's
absolute error, and the value the source holds.

Usage (needs a CUDA device and nvcc): python -m
taste_spokenlm_tpu_torch.scripts.sweep_relpos_fwd
"""

from __future__ import annotations

import json

import torch

from taste_spokenlm_tpu_torch.kernels import _build, relpos_attention
from taste_spokenlm_tpu_torch.scripts._variant import held, load_variant
from taste_spokenlm_tpu_torch.scripts.sweep_gated_mlp import time_us

GROUPS = (1, 2)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_relpos_fwd: needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, t, h, dk = 8, 1599, 8, 128
    xs = [(torch.randn((b, t, h, dk), generator=gen, device=dev) * 1.5
           ).to(torch.bfloat16) for _ in range(4)]
    xs.append((torch.randn((2 * t - 1, h, dk), generator=gen, device=dev)
               * 1.5).to(torch.bfloat16))
    lengths = {"full": [t] * b,
               "ragged": [t, 3 * t // 4, 7 * t // 16, t // 6, t - 1,
                          5 * t // 8, 5 * t // 16, 3 * t // 16]}
    source_value = held("relpos_attention", "FWD_GROUPS")
    refs = {}
    for name, lens in lengths.items():
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        refs[name] = (lens_t, *relpos_attention.relpos_causal_attention_plain(
            *xs, lens_t))
    for groups in GROUPS:
        lib = load_variant("relpos_attention", {"FWD_GROUPS": groups},
                           relpos_attention._SIGNATURES)
        row = {"kernel": "relpos fwd_kernel_mma", "fwd_groups": groups,
               "source_value": source_value, "shape": [b, t, h, dk],
               "device": torch.cuda.get_device_name(0)}
        for name, (lens_t, o_ref, lse_ref) in refs.items():
            o = torch.empty_like(xs[0])
            lse = torch.empty((b * h, t), dtype=torch.float32, device=dev)

            def call():
                _build.check(lib.tsk_relpos_fwd(
                    *map(_build.ptr, (*xs, lens_t, o, lse)), 1, b, t, h,
                    _build.stream_of(o)), "sweep_relpos_fwd")
            call()
            torch.cuda.synchronize()
            row[f"{name}_ms"] = time_us(call) / 1e3
            row[f"{name}_o_rel_err"] = ((o.float() - o_ref.float()).abs().max()
                                        / o_ref.float().abs().max()).item()
            row[f"{name}_lse_err"] = (lse - lse_ref).abs().max().item()
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
