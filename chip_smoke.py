"""Drive the PyTorch/CUDA port on one GPU: reconstruction and completion.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (nvcc).  One model in the bench's
serving layout (`bench.py:755-811` with BENCH_FUSED_MLP=1) drives both
paths: TasteConfig.full() with the f32 tower, everything else bf16, LoRA
merged, the Llama int8 with the int4 tied head, fused qkv and fused MLPs,
the S3 llm stack int8 with fused qkv and fused FFN, fused DiT blocks and
kernel convs.  Its weights are random from seed 0 at the bench's scales in
the float layout (with LoRA adapters) and go through the port's own
quantizer (quant.py).  In order it:

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels from taste_spokenlm_tpu_torch/csrc (one
   nvcc per source, all started together) and prints the seconds each took;
3. runs the full-width reconstruction (step 4 below), then a full-width
   completion (step 5), each with every launch count set to 0 just before
   and read just after;
4. reconstruction: B=1, 40 asr tokens and the whisper log-mel of a seeded
   wav; it checks that it went through every kernel the expected number of
   times, that the S3 decode ran at least 64 steps, that the waveform is
   finite and 256 samples per mel frame, that the tower with kernels picks
   the same taste indices as with the plain versions (>= 0.99) and that
   the flow's mel with kernels is within 2e-2 of the plain versions' for
   the same start noise z, on what the estimator added to it (mel - z),
   printing beside it the same error of the plain bf16 flow against an f32
   copy (the bf16 noise floor);
5. completion, as bench.py:990-1087: extract_vq on the same wav (a 40-token
   llm prefix with the asr word ids), 64 joint text + taste decode steps
   with the bench's sampler (text top-p 0.3, temperature 0.5, repetition
   penalty 1.1, taste greedy, extra_words 64), the host glue (per-word
   taste rows, 128 asr tokens at 2 per word) and synthesize_from_taste (512
   S3 steps, 904 mel frames).  Checks: >= 32 tokens, an S3 decode >= 64
   long, a finite waveform of rms > 1e-7 and 256 samples per mel frame,
   exact launch counts of all six kernels, the same token trajectory from
   the same generator state twice, and a greedy decode with kernels
   against the plain versions agreeing on >= 0.98 of its text steps;
6. holds each kernel against its plain PyTorch version at the shapes the
   completion gives it, and times kernel, plain version and a library
   call that computes the same function (CUDA events, median of 20 after
   warm-up).  Tolerances: flash attention (float32) 1e-4 abs, as both sides
   do true f32 arithmetic in another summation order; the bf16 conv 2e-2
   relative to the plain version's f32-accumulated result, as both round
   to bf16 at the same points but sum in another order; the bf16 fused DiT
   block 2e-2 relative on its increment out - x (the residual would hide
   the attention), at the path's key lengths and at ragged ones, with
   fan-in scaled weights and a peaked softmax.  The script also checks that
   zeroed attention and an unmasked key range each move that increment by
   more than 5x the tolerance.  The int8 / int4 kernels, with fan-in scaled
   random weights through the port's quantizer: matmul_int4 1e-3 relative
   to max|plain| (both sides form the same exact bf16 x int4 products with
   f32 sums, in another order), the fused MLPs 2e-2 relative (their bf16
   activation can differ by one bf16 step where the f32 sums differ); and
   swapped nibble planes / a zeroed gate must move the output by more than
   5x the tolerance;
7. prints a {"kernels": [...]} line, then, as the last line,
   {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

adds torch.profiler traces of one reconstruction, one joint decode and one
synthesis: the device's busy time, its idle share of the wall time, the
kernels with the most device time, and whether the trace holds every
launch that the kernels' counters saw.

Any failed check ends the run with a non-zero exit code and no last line.
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from taste_spokenlm_tpu_torch import quant
from taste_spokenlm_tpu_torch.config import TasteConfig
from taste_spokenlm_tpu_torch.kernels import (KERNEL_SOURCES, _build, conv1d,
                                              flash_attention, fused_dit,
                                              fused_mlp, int4_matmul,
                                              launch_counts,
                                              reset_launch_counts)
from taste_spokenlm_tpu_torch.models.llama import RMSNorm
from taste_spokenlm_tpu_torch.models.sampler import (SamplerConfig,
                                                     build_sampler_tables)
from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM
from taste_spokenlm_tpu_torch.ops.audio import whisper_log_mel
from taste_spokenlm_tpu_torch.ops.quantized import FUSED_MLP_MAX_ROWS

# NVIDIA H100 SXM data sheet (dense): HBM3 bytes/s, f32 outside the tensor
# cores, bf16 on the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

B, T_TOK, MAX_SPEECH, MEL_LEN_MAX = 1, 40, 512, 904
LM_STEPS, SYN_ASR = 64, 128        # joint decode budget; asr tokens, 2 a word


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() over `reps` calls after `warmup`: CUDA
    events around one call, enqueued behind a device sleep of about 2.5 ms,
    so the host's launch overhead is hidden and the events bracket the
    device work alone (a small kernel would otherwise time the Python
    wrapper)."""
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
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, flops / peak_flops * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------------------
# the shapes each kernel sees in one reconstruction, from the config
# ---------------------------------------------------------------------------


def flash_shapes(cfg: TasteConfig, n_frames: int):
    w = cfg.audio_tower.whisper
    t = (n_frames + 1) // 2
    if not flash_attention.can_use_flash(t, t):
        return {}
    return {(B, t, w.encoder_heads, w.d_model // w.encoder_heads):
            w.encoder_layers}


def dit_shapes(cfg: TasteConfig, mel_len: int):
    """{(T, valid keys): launches} of the fused DiT block: the U-Net halves
    T once per down block but the last; 2B rows per call (CFG)."""
    f = cfg.flow
    inner = f.estimator_num_heads * f.estimator_attention_head_dim
    n_ch = len(f.estimator_channels)
    ts, valids = [MEL_LEN_MAX], [mel_len]
    for _ in range(n_ch - 1):
        ts.append((ts[-1] + 1) // 2)
        valids.append((valids[-1] + 1) // 2)
    per_call = {}

    def add(level, n):
        key = (ts[level], valids[level])
        c = f.estimator_channels[min(level, n_ch - 1)]
        if fused_dit.can_use_fused_dit(key[0], c, inner):
            per_call[key] = per_call.get(key, 0) + n
    for i in range(n_ch):                       # down path
        add(i, f.estimator_n_blocks)
    add(n_ch - 1, f.estimator_num_mid_blocks * f.estimator_n_blocks)
    for i in range(n_ch):                       # up path
        add(n_ch - 1 - i, f.estimator_n_blocks)
    return {k: v * f.n_timesteps for k, v in per_call.items()}


def conv_shapes(cfg: TasteConfig):
    """{(C, T, K, D): launches} of conv1d_same in HiFT's ResBlocks."""
    h = cfg.hift
    shapes = {}
    t = MEL_LEN_MAX
    for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
        ch = h.base_channels // (2 ** (i + 1))
        t = (t - 1) * u + k - 2 * ((k - u) // 2)
        if i == len(h.upsample_rates) - 1:
            t += 1                              # reflection pad (1, 0)
        if ch % 128 or t < 4096:
            continue
        blocks = list(zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes))
        blocks.append((h.source_resblock_kernel_sizes[i],
                       h.source_resblock_dilation_sizes[i]))
        for k_r, dils in blocks:
            for d in dils:
                for key in ((ch, t, k_r, d), (ch, t, k_r, 1)):
                    shapes[key] = shapes.get(key, 0) + 1
    return shapes


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_rows(cfg: TasteConfig, dev, gen, mel_len: int, n_frames: int,
                quantized_launches: dict):
    """Each kernel against its plain version at the shapes of one completion
    (`quantized_launches`: {kernel: {rows M: launches}} of the int8 / int4
    kernels); -> (name, source, replaces, tolerance, per-shape rows)."""
    rows = []

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # flash attention, f32 (the tower's dtype)
    shapes = []
    for (b, t, h, d), n in flash_shapes(cfg, n_frames).items():
        q, k, v = (randn(b, t, h, d, dtype=torch.float32) for _ in range(3))
        out = flash_attention.flash_attention(q, k, v)
        ref = flash_attention.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        check(err <= 1e-4, f"flash_attention max abs err {err} > 1e-4")
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        bnd, by = bound_ms(4 * 4 * b * t * h * d, 4 * b * h * t * t * d,
                           F32_FLOPS)
        shapes.append({
            "shape": [b, t, h, d], "dtype": "float32", "launches": n,
            "max_abs_err": err, "rel_err": rel,
            "ms": time_ms(lambda: flash_attention.flash_attention(q, k, v)),
            "plain_ms": time_ms(
                lambda: flash_attention.flash_attention_plain(q, k, v)),
            "library_ms": time_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh)),
            "bound_ms": bnd, "bound_by": by})
    rows.append(("flash_attention", "taste_spokenlm_tpu_torch/csrc/flash_attention.cu",
                 "taste_spokenlm_tpu/ops/pallas/flash_attention.py:120",
                 "max abs err <= 1e-4 (f32)", shapes))

    # fused DiT block, bf16.  Fan-in scaled weights with q/k at gain 2, so
    # the softmax is peaked and the attention branch is as large as the MLP
    # branch; the error is taken on the block's increment (out - x), which a
    # wrong attention or key mask moves by far more than the tolerance (the
    # residual x alone would hide both).
    f = cfg.flow
    c, heads, hd = f.estimator_channels[-1], f.estimator_num_heads, \
        f.estimator_attention_head_dim
    inner = heads * hd
    w = lambda n_in, n_out, gain=1.0: randn(  # noqa: E731
        n_in, n_out, scale=gain * n_in ** -0.5)
    vec = lambda n, base=0.0: base + randn(n, scale=0.1)  # noqa: E731
    params = {"norm1": {"scale": vec(c, 1.0), "bias": vec(c)},
              "attn1": {"to_q": {"kernel": w(c, inner, 2.0)},
                        "to_k": {"kernel": w(c, inner, 2.0)},
                        "to_v": {"kernel": w(c, inner)},
                        "to_out": {"kernel": w(inner, c), "bias": vec(c)}},
              "norm3": {"scale": vec(c, 1.0), "bias": vec(c)},
              "ff_in": {"kernel": w(c, 4 * c), "bias": vec(4 * c)},
              "ff_out": {"kernel": w(4 * c, c), "bias": vec(c)}}
    no_attn = {**params, "attn1": {**params["attn1"], "to_v": {
        "kernel": torch.zeros_like(params["attn1"]["to_v"]["kernel"])}}}
    n_weights = sum(v.numel() for sub in params.values()
                    for v in _leaves(sub))
    block = lambda fn, x, lens, p=params: fn(  # noqa: E731
        x, lens, p, heads=heads, head_dim=hd)
    shapes = []
    for (t, valid), n in dit_shapes(cfg, mel_len).items():
        x = randn(2 * B, t, c, scale=0.5)
        lengths = torch.full((2 * B,), valid, dtype=torch.int32, device=dev)
        # the path's lengths, and ragged ones with half the keys masked
        ragged = torch.tensor([valid] * (2 * B - 1) + [t // 2],
                              dtype=torch.int32, device=dev)
        errs = []
        for lens in (lengths, ragged):
            ref = block(fused_dit.fused_dit_block_plain, x, lens)
            err, rel = increment_err(block(fused_dit.fused_dit_block, x, lens),
                                     ref, x, lens)
            check(rel <= 2e-2, f"fused_dit_block increment rel err {rel} > "
                               f"2e-2 at T={t}, lengths {lens.tolist()}")
            errs.append((err, rel))
        # the check sees the attention (values zeroed) and the key mask
        # (the ragged rows unmasked): each moves the increment past it
        attn_effect = increment_err(
            block(fused_dit.fused_dit_block_plain, x, ragged, no_attn),
            ref, x, ragged)[1]
        mask_effect = increment_err(
            block(fused_dit.fused_dit_block_plain, x,
                  torch.full_like(ragged, t)), ref, x, ragged)[1]
        check(min(attn_effect, mask_effect) > 5 * 2e-2,
              f"fused_dit_block check too blunt at T={t}: zeroed attention "
              f"moves it {attn_effect}, an unmasked key range {mask_effect}")
        m = 2 * B * t
        flops = (2 * m * c * 3 * inner + 4 * 2 * B * heads * t * valid * hd
                 + 2 * m * inner * c + 2 * 2 * m * c * 4 * c)
        bnd, by = bound_ms(2 * (2 * m * c + n_weights), flops, BF16_FLOPS)
        shapes.append({
            "shape": [2 * B, t, c], "valid_keys": valid,
            "ragged_keys": ragged.tolist(), "dtype": "bfloat16",
            "launches": n, "max_abs_err": max(e for e, _ in errs),
            "rel_err": max(r for _, r in errs),
            "zeroed_attention_rel": attn_effect,
            "unmasked_keys_rel": mask_effect,
            "ms": time_ms(lambda: block(fused_dit.fused_dit_block, x, lengths)),
            "plain_ms": time_ms(
                lambda: block(fused_dit.fused_dit_block_plain, x, lengths)),
            "library_ms": None, "bound_ms": bnd, "bound_by": by})
    rows.append(("fused_dit_block", "taste_spokenlm_tpu_torch/csrc/fused_dit.cu",
                 "taste_spokenlm_tpu/ops/pallas/fused_dit.py:110",
                 "rel err of the increment out - x <= 2e-2 over valid rows, "
                 "path and ragged lengths (bf16)", shapes))

    # conv1d same, bf16, channels-last
    shapes = []
    for (ch, t, k, d), n in conv_shapes(cfg).items():
        x = randn(B, t, ch)
        w = randn(k, ch, ch, scale=0.02)
        bias = randn(ch, scale=0.02)
        w_oik = w.permute(2, 1, 0).contiguous()
        out = conv1d.conv1d_same(x, w, bias, dilation=d)
        ref = conv1d.conv1d_same_plain(x, w, bias, dilation=d)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        check(rel <= 2e-2, f"conv1d_same rel err {rel} > 2e-2 at "
                           f"C={ch} T={t} K={k} D={d}")
        pad = (k - 1) * d // 2
        bnd, by = bound_ms(2 * (2 * B * t * ch + k * ch * ch + ch),
                           2 * B * t * ch * ch * k, BF16_FLOPS)
        shapes.append({
            "shape": [B, t, ch], "K": k, "D": d, "dtype": "bfloat16",
            "launches": n, "max_abs_err": err, "rel_err": rel,
            "ms": time_ms(lambda: conv1d.conv1d_same(x, w, bias, dilation=d)),
            "plain_ms": time_ms(lambda: conv1d.conv1d_same_plain(
                x, w, bias, dilation=d)),
            "library_ms": time_ms(lambda: F.conv1d(
                x.transpose(1, 2), w_oik, bias, padding=pad, dilation=d)),
            "bound_ms": bnd, "bound_by": by})
    rows.append(("conv1d_same", "taste_spokenlm_tpu_torch/csrc/conv1d.cu",
                 "taste_spokenlm_tpu/ops/pallas/conv1d.py:45",
                 "rel err <= 2e-2 (bf16)", shapes))
    rows.extend(quantized_kernel_rows(cfg, dev, gen, quantized_launches, randn))
    return rows


def quantized_kernel_rows(cfg: TasteConfig, dev, gen, launches: dict, randn):
    """The fused int8 MLPs and the int4 head against their plain versions,
    with fan-in scaled random weights through the port's quantizer, each
    with a reach check: a zeroed gate / swapped nibble planes must move the
    output by more than 5x the tolerance."""
    def q8(n_in, n_out):
        q = quant.quantize_kernel(
            torch.randn(n_in, n_out, generator=gen, device=dev) * n_in ** -0.5)
        return q["base_q"], q["base_scale"]

    def rel(out, ref):
        return ((out - ref).abs().max() / ref.abs().max()).item()

    def row(kernel, plain, args, blind_args, tol, n, n_bytes, flops,
            library=None, **extra):
        out, ref = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        err, reach = rel(out, ref), rel(plain(*blind_args), ref)
        m = args[0].shape[0]
        check(err <= tol, f"{kernel.__name__} rel err {err} > {tol} at M={m}")
        check(reach > 5 * tol, f"{kernel.__name__} check too blunt at M={m}: "
                               f"the broken input moves it only {reach}")
        bnd, by = bound_ms(n_bytes, flops, BF16_FLOPS)
        return {"launches": n, "max_abs_err": (out - ref).abs().max().item(),
                "rel_err": err, "broken_input_rel": reach,
                "ms": time_ms(lambda: kernel(*args)),
                "plain_ms": time_ms(lambda: plain(*args)),
                "library_ms": None if library is None else time_ms(library),
                "bound_ms": bnd, "bound_by": by, **extra}

    out = []
    llama = cfg.spoken_lm.llama
    h, i = llama.hidden_size, llama.intermediate_size
    (wg, sg), (wu, su), (wd, sd) = q8(h, i), q8(h, i), q8(i, h)
    shapes = []
    for m, n in launches["gated_mlp_int8"].items():
        x = randn(m, h)
        shapes.append(row(
            fused_mlp.gated_mlp_int8, fused_mlp.gated_mlp_int8_plain,
            (x, wg, sg, wu, su, wd, sd),
            (x, torch.zeros_like(wg), sg, wu, su, wd, sd), 2e-2, n,
            3 * h * i + 4 * (2 * i + h) + m * h * (2 + 4), 3 * 2 * m * h * i,
            shape=[m, h, i], broken_input="zeroed gate weights"))
    out.append(("gated_mlp_int8", "taste_spokenlm_tpu_torch/csrc/fused_mlp.cu",
                "taste_spokenlm_tpu/ops/pallas/fused_mlp.py:102",
                "rel err <= 2e-2 of max|plain| (bf16 activation)", shapes))

    s3 = cfg.speech_decoder.llm
    d, i = s3.output_size, s3.linear_units
    (w1, s1), (w2, s2) = q8(d, i), q8(i, d)
    b1 = 0.1 * torch.randn(i, generator=gen, device=dev)
    b2 = 0.1 * torch.randn(d, generator=gen, device=dev)
    shapes = []
    for m, n in launches["ffn_int8"].items():
        x = randn(m, d)
        shapes.append(row(
            fused_mlp.ffn_int8, fused_mlp.ffn_int8_plain,
            (x, w1, s1, b1, w2, s2, b2),
            (x, torch.zeros_like(w1), s1, b1, w2, s2, b2), 2e-2, n,
            2 * d * i + 4 * (2 * i + 2 * d) + m * d * (2 + 4), 2 * 2 * m * d * i,
            shape=[m, d, i], broken_input="zeroed first-projection weights"))
    out.append(("ffn_int8", "taste_spokenlm_tpu_torch/csrc/fused_mlp.cu",
                "taste_spokenlm_tpu/ops/pallas/fused_mlp.py:383",
                "rel err <= 2e-2 of max|plain| (bf16 activation)", shapes))

    d, v = llama.hidden_size, llama.vocab_size
    wp, scale = int4_matmul.quantize_int4(
        torch.randn(d, v, generator=gen, device=dev) * d ** -0.5)
    swapped = (wp >> 4) | (wp << 4)
    w16 = int4_matmul.dequantize_int4(wp, scale).to(torch.bfloat16)
    shapes = []
    for m, n in launches["matmul_int4"].items():
        x = randn(m, d)
        shapes.append(row(
            int4_matmul.matmul_int4, int4_matmul.matmul_int4_plain,
            (x, wp, scale), (x, swapped, scale), 1e-3, n,
            wp.numel() + 4 * scale.numel() + m * (2 * d + 4 * v), 2 * m * d * v,
            library=lambda: x @ w16, shape=[m, d, v],
            broken_input="swapped nibble planes",
            library_call="x_bf16 @ W_bf16 (the head dequantized once)"))
    out.append(("matmul_int4", "taste_spokenlm_tpu_torch/csrc/int4_matmul.cu",
                "taste_spokenlm_tpu/ops/pallas/int4_matmul.py:114",
                "rel err <= 1e-3 of max|plain|", shapes))
    return out


def increment_err(out, ref, x, lengths):
    """(max abs err, the same over the largest |ref - x|) of out against ref
    over each row's valid positions: the error of a residual block's
    increment.  Padded rows are junk by contract and left out."""
    err = scale = 0.0
    for b, n in enumerate(lengths.tolist()):
        o, r, xb = (a[b, :n].float() for a in (out, ref, x))
        err = max(err, (o - r).abs().max().item())
        scale = max(scale, (r - xb).abs().max().item())
    return err, err / scale


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# the full-width reconstruction
# ---------------------------------------------------------------------------


def random_state_dict(model: torch.nn.Module, gen) -> dict:
    """Seeded random weights scaled as bench.py's _fill_variables (0.02 for
    matrices, 1e-3 for vectors), except that norm scales and Snake alphas
    sit near 1, their initial value, so activations stay O(1) and the
    taste-index comparison is not decided by the codebook norms alone.
    The CFM estimator's transformer blocks take fan-in scaled matrices: at
    0.02 their softmax would be near uniform over ~900 keys, and the
    attention branch too small for the flow's kernel-against-plain check
    to see.  The Llama's RMSNorm weights are 0.01 x N(0, 1): at the bench's
    1e-3 the MLPs' output never reaches the bf16 residual stream (the
    greedy check would be blind to the kernels), and near 1 the random
    16-layer Llama is chaotic in bf16, so its greedy trajectory with the
    kernels parts from the plain versions' within a few steps, whatever the
    kernels' own error."""
    near_one, rms = set(), set()
    for name, mod in model.named_modules():
        if isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
            near_one.add(f"{name}.weight")
        elif isinstance(mod, RMSNorm):
            rms.add(f"{name}.weight")
    sd = {}
    for name, ref in model.state_dict().items():
        shape = ref.shape
        r = torch.randn(shape, generator=gen, device=ref.device)
        dit_matrix = (".estimator." in name and ref.dim() == 2
                      and (".attn1." in name or ".ff.net." in name))
        if name in near_one or name.endswith(".alpha"):
            v = 1.0 + 0.02 * r
        elif name in rms:
            v = 0.01 * r
        elif name.endswith(("cluster_size", "initted")):
            v = torch.ones(shape, device=ref.device)
        elif dit_matrix:
            v = shape[1] ** -0.5 * r
        elif ref.dim() >= 2:
            v = 0.02 * r
        else:
            v = 1e-3 * r
        sd[name] = v.to(ref.dtype)
    return sd


def inputs(cfg: TasteConfig, dev):
    rng = np.random.RandomState(0)
    sr, secs = 16000, 14.0
    tt = np.arange(int(sr * secs)) / sr
    wav = (0.3 * np.sin(2 * np.pi * 180.0 * tt * (1 + 0.1 * np.sin(tt)))
           + 0.02 * rng.randn(tt.size)).astype(np.float32)
    mel = whisper_log_mel(torch.from_numpy(wav).to(dev))
    vocab = cfg.audio_tower.whisper.vocab_size
    return {
        "speaker_embeds": torch.from_numpy(
            rng.randn(B, cfg.speech_decoder.spk_embed_dim).astype(np.float32)).to(dev),
        "asr_token_ids": torch.from_numpy(
            rng.randint(100, 20000, (B, T_TOK)) % vocab).to(dev),
        "asr_token_lengths": torch.full((B,), T_TOK, device=dev),
        "asr_word_ids": (torch.arange(T_TOK, device=dev) // 2)[None].repeat(B, 1),
        "audio_features": mel,
    }


def reconstruct(model, x, gen):
    return model.inference_reconstruction(
        x["speaker_embeds"], x["asr_token_ids"], x["asr_token_lengths"],
        x["asr_word_ids"], x["audio_features"], max_speech_steps=MAX_SPEECH,
        mel_len_max=MEL_LEN_MAX, generator=gen)


def stage_times(model, x, out, gen):
    """Seconds of each stage of one reconstruction, each ending in a
    synchronize."""
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0
    tw = model.audio_tower
    enc, t_tower = timed(lambda: tw(x["audio_features"], x["asr_token_ids"],
                                    x["asr_token_lengths"], x["asr_word_ids"]))
    _, t_s3 = timed(lambda: model.speech_decoder.generate(
        x["speaker_embeds"], enc["audio_unit_embeds"], enc["audio_unit_lengths"],
        x["asr_token_ids"], x["asr_token_lengths"], max_steps=MAX_SPEECH,
        generator=gen))
    tokens = torch.clamp(out["speech_token_ids"], min=0)
    vg = model.voice_generator
    (mel, _), t_flow = timed(lambda: vg.flow.inference(
        tokens, out["speech_token_lengths"], x["speaker_embeds"], MEL_LEN_MAX,
        generator=gen))
    _, t_hift = timed(lambda: vg.hift(mel, generator=gen))
    return {"tower_s": t_tower, "s3_decode_s": t_s3, "flow_s": t_flow,
            "hift_s": t_hift}


def flow_parity(model, cfg: TasteConfig, out, x, gen, mel_len: int):
    """The flow's mel with kernels against the plain versions for the same
    start noise z, as the relative error of what the estimator added to z
    (mel - z) over the valid frames; and the same error of the plain bf16
    flow against an f32 copy of it, the bf16 noise floor."""
    dev = x["speaker_embeds"].device
    tokens = torch.clamp(out["speech_token_ids"], min=0)
    z = torch.randn((B, MEL_LEN_MAX, cfg.flow.output_size), generator=gen,
                    device=dev)
    run = lambda flow: flow.inference(  # noqa: E731
        tokens, out["speech_token_lengths"], x["speaker_embeds"], MEL_LEN_MAX,
        z=z)[0]
    flow = model.voice_generator.flow
    mel_k = run(flow)
    model.set_use_kernels(False)
    mel_p = run(flow)
    mel_32 = run(copy.deepcopy(flow).float())
    model.set_use_kernels(True)
    lengths = torch.full((B,), mel_len, device=dev)
    return (increment_err(mel_k, mel_p, z, lengths)[1],
            increment_err(mel_p, mel_32, z, lengths)[1])


def device_profile(run, wall_s: float):
    """Device time of run() from a torch.profiler trace: the union of the
    CUDA kernel intervals against the unprofiled wall time, and the kernels
    with the most device time.  The trace is complete when it holds as many
    launches of our kernels as their counters saw during it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    counts = launch_counts()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"busy_s": None, "note": "the profiler recorded no device time"}
    busy_us, start, end = 0.0, None, None
    for s, e in sorted((k.time_range.start, k.time_range.end) for k in kernels):
        if end is None or s > end:
            busy_us += 0.0 if end is None else end - start
            start, end = s, e
        else:
            end = max(end, e)
    busy_us += end - start
    by_name = {}
    for k in kernels:
        n, us = by_name.get(k.name, (0, 0.0))
        by_name[k.name] = (n + 1, us + k.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    expected = {"mlp_pass1": counts["gated_mlp_int8"] + counts["ffn_int8"],
                "int4_kernel": counts["matmul_int4"],
                "attn_kernel<float": counts["flash_attention"]}
    seen = {key: sum(1 for k in kernels if key in k.name) for key in expected}
    return {"busy_s": busy_us / 1e6, "idle_share": 1.0 - busy_us / 1e6 / wall_s,
            "n_kernel_launches": len(kernels), "trace_complete": seen == expected,
            "traced_launches": seen, "counted_launches": expected,
            "top_kernels": [{"name": n[:90], "launches": c, "ms": us / 1e3}
                            for n, (c, us) in top]}


# ---------------------------------------------------------------------------
# the serving model and the completion
# ---------------------------------------------------------------------------


class VocabScan:
    """A deterministic id -> subword map standing in for the Llama tokenizer
    when building the sampler tables (bench.py:138-147): the tables' shapes
    and the sampler's cost are those of real ones."""

    def decode(self, i):
        return (" the", "ing", ".", " end.", "!!", "a\nb", " word", "s",
                ",'", " no.", "xyz")[i % 11]


def configs():
    """(float layout, serving layout) of TasteConfig.full(): the serving
    one is bench.py:755-811 with BENCH_FUSED_MLP=1."""
    cfg = TasteConfig.full()
    cfg = cfg.replace(flow=cfg.flow.replace(fused_dit_serving=True),
                      hift=cfg.hift.replace(pallas_conv=True))
    sd, lm = cfg.speech_decoder, cfg.spoken_lm
    serving = cfg.replace(
        spoken_lm=lm.replace(use_lora=False, llama=lm.llama.replace(
            quantized_serving="int8", quantized_embed_serving="int4head",
            fused_qkv_serving=True, fused_mlp_serving=True)),
        speech_decoder=sd.replace(llm=sd.llm.replace(
            quantized_serving="int8", fused_qkv_serving=True,
            fused_mlp_serving=True)))
    return cfg, serving


def serving_state_dict(sd: dict, cfg: TasteConfig) -> dict:
    """The float model's state dict -> the serving layout's, by the port's
    quantizer: LoRA merged, the Llama int8 with the int4 tied head, fused
    qkv and separate MLP projections; the S3 llm stack and its head int8."""
    lm_pre, llm_pre = "spoken_lm.language_model.", "speech_decoder.llm."
    head = "speech_decoder.llm_decoder"
    sub = lambda pre: {k[len(pre):]: v for k, v in sd.items()  # noqa: E731
                       if k.startswith(pre)}
    lora = cfg.spoken_lm.lora
    lm = quant.quantize_llama_params(
        quant.merge_lora_params(sub(lm_pre), lora.alpha, lora.r),
        include_embed=True, embed_head_mode="int4head", fuse_qkv=True,
        fused_mlp=True)
    enc = quant.quantize_encoder_params(sub(llm_pre), fuse_qkv=True,
                                        fused_mlp=True)
    out = {k: v for k, v in sd.items()
           if not k.startswith((lm_pre, llm_pre, head + "."))}
    out.update({lm_pre + k: v for k, v in lm.items()})
    out.update({llm_pre + k: v for k, v in enc.items()})
    out.update(quant.quantize_dense_leaf(sd, head))
    return out


def build_model(dev, gen):
    """The serving model, its config and the parameter counts."""
    float_cfg, cfg = configs()
    kw = dict(dtype=torch.bfloat16, tower_dtype=torch.float32, device=dev)
    with torch.device(dev):
        float_model = TasteForCausalLM(float_cfg, **kw)
        n_float = sum(p.numel() for p in float_model.parameters())
        sd = random_state_dict(float_model, gen)
        del float_model
        model = TasteForCausalLM(cfg, **kw)
    model.load_state_dict(serving_state_dict(sd, cfg), strict=True)
    return model.eval(), cfg, n_float


def lm_prefix(cfg: TasteConfig, x, dev):
    """The spoken-LM prefix of the same utterance: 40 llm ids (bench.py:
    836-844) with the asr word ids."""
    rng = np.random.RandomState(1)
    ids = rng.randint(100, 120000, (B, T_TOK)) % cfg.spoken_lm.llama.vocab_size
    return {"llm_token_ids": torch.from_numpy(ids).to(dev),
            "llm_token_lengths": torch.full((B,), T_TOK, device=dev),
            "llm_word_ids": x["asr_word_ids"]}


def synth_batch(cfg: TasteConfig, out, dev):
    """Host glue (bench.py:1030-1042): the decoded taste rows dense per word
    and 128 asr tokens at 2 per word."""
    n_taste = max(int(out["num_taste_words"][0]), 1)
    l = cfg.audio_tower.quantizer.num_quantizers
    taste = torch.zeros((B, LM_STEPS, l), dtype=torch.long, device=dev)
    taste[0, :n_taste] = out["taste_indices"][0, :n_taste].clamp(min=0)
    rng = np.random.RandomState(2)
    ids = rng.randint(100, 20000, (B, SYN_ASR)) % cfg.audio_tower.whisper.vocab_size
    words = np.minimum(np.arange(SYN_ASR) // 2, LM_STEPS - 1)[None].repeat(B, 0)
    return (taste, torch.from_numpy(ids).to(dev),
            torch.full((B,), SYN_ASR, device=dev), torch.from_numpy(words).to(dev))


def joint_decode(model, scfg, tables, lm, llm_indices, seed=None):
    gen = (None if seed is None
           else torch.Generator(device=llm_indices.device).manual_seed(seed))
    return model.generate_completion(
        scfg, tables, llm_indices, lm["llm_token_ids"], lm["llm_token_lengths"],
        lm["llm_word_ids"], "audio", LM_STEPS, generator=gen)


def prefill_hidden(model, lm, llm_indices):
    """The joint decode's first hidden state (after the prefix prefill)."""
    st = model.spoken_lm.generate_stream_init(
        model._cb(), llm_indices, lm["llm_token_ids"], lm["llm_token_lengths"],
        lm["llm_word_ids"], "audio", 1)
    return st["hidden"].float()


def complete(model, cfg, x, lm, scfg, tables, gen):
    """One completion: extract_vq, the joint decode, the host glue and the
    synthesis, each timed to a synchronize."""
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0
    (_, idx), t_vq = timed(lambda: model.extract_vq(
        x["asr_token_ids"], x["asr_token_lengths"], x["asr_word_ids"],
        lm["llm_token_ids"], lm["llm_token_lengths"], lm["llm_word_ids"],
        x["audio_features"]))
    out, t_dec = timed(lambda: joint_decode(model, scfg, tables, lm, idx, 5))
    taste, ids, lens, words = synth_batch(cfg, out, idx.device)
    syn, t_syn = timed(lambda: model.synthesize_from_taste(
        x["speaker_embeds"], taste, ids, lens, words,
        max_speech_steps=MAX_SPEECH, mel_len_max=MEL_LEN_MAX, generator=gen))
    return idx, out, syn, {"extract_vq_s": t_vq, "joint_decode_s": t_dec,
                           "synthesis_s": t_syn}


def check_counts(counts: dict, expected: dict, path: str) -> None:
    """Every kernel launched exactly as often as the config implies, and
    each that the path runs at least once."""
    for name, n in counts.items():
        want = expected.get(name, 0)
        check(n == want, f"{path}: {name} launched {n} times, the config "
                         f"implies {want}")
    for name, n in expected.items():
        check(counts[name] > 0, f"{path}: {name} never launched")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one reconstruction and one completion "
                         "with torch.profiler (device busy time, idle share, "
                         "top kernels; adds a few minutes)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log({"torch": torch.__version__, "cuda": torch.version.cuda,
         "device": torch.cuda.get_device_name(0)})

    build_s = _build.build(KERNEL_SOURCES)
    log({"build_s": build_s})

    gen = torch.Generator(device=dev).manual_seed(0)
    t_start = t0 = time.perf_counter()
    model, cfg, n_float = build_model(dev, gen)
    torch.cuda.synchronize()
    log({"model_init_s": time.perf_counter() - t0,
         "float_params": n_float,
         "serving_bytes": sum(t.numel() * t.element_size() for t in
                              model.state_dict().values())})
    x = inputs(cfg, dev)
    n_frames = x["audio_features"].shape[-1]
    check(tuple(x["audio_features"].shape) == (B, 128, 3000),
          f"mel shape {tuple(x['audio_features'].shape)}")
    s3 = cfg.speech_decoder.llm
    s3_ffn = lambda prefix_rows, length: s3.num_blocks * (  # noqa: E731
        min(length + 1, MAX_SPEECH) + (B * prefix_rows <= FUSED_MLP_MAX_ROWS))

    # ---- reconstruction: warm-up (cuDNN / cuBLAS plans), then counted ----
    reconstruct(model, x, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = reconstruct(model, x, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    dec_len = int(out["speech_token_lengths"].min())
    check(dec_len >= 64, f"degenerate S3 decode length {dec_len}")
    mel_len = int(model.voice_generator.flow.mel_lengths(
        out["speech_token_lengths"]).clamp(max=MEL_LEN_MAX)[0])
    wav = out["waveform"]
    check(tuple(wav.shape) == (B, 256 * MEL_LEN_MAX), f"wav shape {wav.shape}")
    check(bool(torch.isfinite(wav).all()), "non-finite waveform")
    wav_len = int(out["waveform_lengths"][0])
    check(wav_len == 256 * mel_len, f"wav length {wav_len} != 256 x {mel_len}")
    audio_s = wav_len / cfg.hift.sampling_rate
    check_counts(counts, {
        "flash_attention": sum(flash_shapes(cfg, n_frames).values()),
        "fused_dit_block": sum(dit_shapes(cfg, mel_len).values()),
        "conv1d_same": sum(conv_shapes(cfg).values()),
        "ffn_int8": s3_ffn(3 + T_TOK, dec_len)}, "reconstruction")
    log({"reconstruction": {
        "wall_s": wall, "audio_s": audio_s, "rtf": wall / audio_s,
        "s3_decode_len": dec_len, "mel_frames": mel_len, "wav_len": wav_len,
        "peak_mem_gb": peak_gb, "launches": counts}})
    log({"stages": stage_times(model, x, out, gen)})
    if opts.profile:
        log({"device_profile": device_profile(
            lambda: reconstruct(model, x, gen), wall)})

    # the tower with kernels against the tower with the plain versions
    args = (x["audio_features"], x["asr_token_ids"], x["asr_token_lengths"],
            x["asr_word_ids"])
    with torch.no_grad():
        idx_k = model.audio_tower(*args)["quantized_indices"]
        model.set_use_kernels(False)
        idx_p = model.audio_tower(*args)["quantized_indices"]
        model.set_use_kernels(True)
    agree = (idx_k == idx_p).float().mean().item()
    check(agree >= 0.99, f"taste-index agreement {agree} < 0.99")

    mel_rel, mel_floor = flow_parity(model, cfg, out, x, gen, mel_len)
    check(mel_rel <= 2e-2, f"flow mel rel err {mel_rel} > 2e-2 on mel - z")
    log({"parity": {"taste_index_agreement": agree, "flow_mel_rel_err": mel_rel,
                    "flow_mel_bf16_vs_f32_rel_err": mel_floor}})

    # ---- completion: warm-up, then counted ----
    llama = cfg.spoken_lm.llama
    tables = {k: torch.from_numpy(v).to(dev) for k, v in
              build_sampler_tables(VocabScan(), llama.vocab_size).items()}
    scfg = SamplerConfig(
        delay=cfg.spoken_lm.delay, delay_level=cfg.spoken_lm.delay_level,
        extra_words=LM_STEPS, text_top_p=0.3, taste_top_p=0.0,
        text_temperature=0.5, repetition_penalty=1.1, has_prefix=True)
    lm = lm_prefix(cfg, x, dev)
    complete(model, cfg, x, lm, scfg, tables, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    idx, dec, syn, walls = complete(model, cfg, x, lm, scfg, tables, gen)
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    steps, n_tokens = int(dec["steps"]), int(dec["num_tokens"][0])
    check(n_tokens >= LM_STEPS // 2, f"degenerate joint decode: {n_tokens} tokens")
    s3_len = int(syn["speech_token_lengths"][0])
    check(s3_len >= 64, f"degenerate S3 decode length {s3_len}")
    syn_mel = int(model.voice_generator.flow.mel_lengths(
        syn["speech_token_lengths"]).clamp(max=MEL_LEN_MAX)[0])
    wav = syn["waveform"].float()
    check(bool(torch.isfinite(wav).all()), "non-finite completion waveform")
    rms = wav.pow(2).mean().sqrt().item()
    check(rms > 1e-7, f"degenerate completion waveform rms {rms}")
    syn_wav_len = int(syn["waveform_lengths"][0])
    check(syn_wav_len == 256 * syn_mel,
          f"completion wav length {syn_wav_len} != 256 x {syn_mel}")
    syn_audio_s = syn_wav_len / cfg.hift.sampling_rate
    lm_prefill = B * (1 + T_TOK + cfg.spoken_lm.delay)
    check(lm_prefill <= FUSED_MLP_MAX_ROWS and B * (3 + SYN_ASR) <= FUSED_MLP_MAX_ROWS,
          "a prefill past the fused MLPs' row limit")
    quantized_launches = {
        "gated_mlp_int8": {1: llama.num_hidden_layers * steps,
                           lm_prefill: llama.num_hidden_layers},
        "ffn_int8": {1: s3_ffn(3 + SYN_ASR, s3_len) - s3.num_blocks,
                     B * (3 + SYN_ASR): s3.num_blocks},
        "matmul_int4": {1: steps}}
    check_counts(counts, {
        "flash_attention": sum(flash_shapes(cfg, n_frames).values()),
        "fused_dit_block": sum(dit_shapes(cfg, syn_mel).values()),
        "conv1d_same": sum(conv_shapes(cfg).values()),
        **{k: sum(v.values()) for k, v in quantized_launches.items()}},
        "completion")
    log({"completion": {
        **walls, "joint_decode_steps": steps, "tokens": n_tokens,
        "ms_per_step": 1e3 * walls["joint_decode_s"] / steps,
        "taste_words": int(dec["num_taste_words"][0]),
        "s3_decode_len": s3_len, "mel_frames": syn_mel, "audio_s": syn_audio_s,
        "wav_rms": rms, "completion_rtf": (walls["joint_decode_s"]
                                           + walls["synthesis_s"]) / syn_audio_s,
        "peak_mem_gb": peak_gb, "launches": counts}})

    # the same generator state gives the same trajectory; a greedy decode
    # with the kernels against one with their plain versions
    again = joint_decode(model, scfg, tables, lm, idx, 5)
    check(torch.equal(again["llm_token_ids"], dec["llm_token_ids"])
          and torch.equal(again["taste_indices"], dec["taste_indices"]),
          "the joint decode is not deterministic for one generator state")
    greedy = scfg._replace(text_top_p=0.0)
    tok_k = joint_decode(model, greedy, tables, lm, idx)
    model.set_use_kernels(False)
    tok_p = joint_decode(model, greedy, tables, lm, idx)
    h_p = prefill_hidden(model, lm, idx)
    model.set_use_kernels(True)
    h_k = prefill_hidden(model, lm, idx)
    n = max(int(tok_k["num_tokens"][0]), int(tok_p["num_tokens"][0]), 1)
    greedy_agree = (tok_k["llm_token_ids"][0, :n]
                    == tok_p["llm_token_ids"][0, :n]).float().mean().item()
    check(greedy_agree >= 0.98,
          f"greedy text trajectory agreement {greedy_agree} < 0.98")
    hidden_rel = ((h_k - h_p).abs().max() / h_p.abs().max()).item()
    check(hidden_rel > 0, "the greedy check is blind: the joint decode's "
                          "hidden state is the same with and without kernels")
    log({"completion_parity": {
        "repeat_identical": True, "greedy_text_agreement": greedy_agree,
        "greedy_tokens": n, "greedy_text_ids": tok_k["llm_token_ids"][0, :8].tolist(),
        "prefill_hidden_rel_err": hidden_rel}})
    if opts.profile:
        taste, ids, lens, words = synth_batch(cfg, dec, dev)
        log({"joint_decode_device_profile": device_profile(
            lambda: joint_decode(model, scfg, tables, lm, idx, 5),
            walls["joint_decode_s"])})
        log({"synthesis_device_profile": device_profile(
            lambda: model.synthesize_from_taste(
                x["speaker_embeds"], taste, ids, lens, words,
                max_speech_steps=MAX_SPEECH, mel_len_max=MEL_LEN_MAX,
                generator=gen), walls["synthesis_s"])})

    with torch.no_grad():
        rows = kernel_rows(cfg, dev, gen, syn_mel, n_frames, quantized_launches)
    kernels = []
    for name, source, replaces, tolerance, shapes in rows:
        check(bool(shapes), f"{name}: no shape of the main path")
        total = lambda key: sum(s[key] * s["launches"] for s in shapes)  # noqa: E731
        lib = (None if any(s["library_ms"] is None for s in shapes)
               else total("library_ms"))
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": max(shapes, key=lambda s: s["bound_ms"] * s["launches"]
                            )["bound_by"],
            "library_ms": lib, "tolerance": tolerance, "verdict": "pass",
            "per": "one completion: per-launch times x launches; per-shape "
                   "rows in 'shapes'",
            "shapes": shapes})
    log({"total_s_after_build": time.perf_counter() - t_start})
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
