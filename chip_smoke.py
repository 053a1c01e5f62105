"""Drive the PyTorch/CUDA port of the reconstruction path on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (nvcc).  In order it:

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels from taste_spokenlm_tpu_torch/csrc (one
   nvcc per source, all started together) and prints the seconds each took;
3. holds each kernel against its plain PyTorch version at the shapes the
   reconstruction gives it, and times kernel, plain version and a library
   call that computes the same function (CUDA events, median of 20 after
   warm-up).  Tolerances: flash attention (float32) 1e-4 abs, as both sides
   do true f32 arithmetic in another summation order; the bf16 conv 2e-2
   relative to the plain version's f32-accumulated result, as both round
   to bf16 at the same points but sum in another order; the bf16 fused DiT
   block 2e-2 relative on its increment out - x (the residual would hide
   the attention), at the path's key lengths and at ragged ones, with
   fan-in scaled weights and a peaked softmax.  The script also checks that
   zeroed attention and an unmasked key range each move that increment by
   more than 5x the tolerance;
4. runs the full-width reconstruction (TasteConfig.full() in the serving
   layout: f32 tower, bf16 speech decoder / flow / HiFT, fused DiT blocks
   and kernel convs on) on B=1, 40 asr tokens and the whisper log-mel of a
   seeded wav, with seeded random weights, and checks that it went through
   every kernel the expected number of times, that the S3 decode ran at
   least 64 steps, that the waveform is finite and 256 samples per mel
   frame, that the tower with kernels picks the same taste indices as with
   the plain versions (>= 0.99) and that the flow's mel with kernels is
   within 2e-2 of the plain versions' for the same start noise z, on what
   the estimator added to it (mel - z), printing beside it the same error
   of the plain bf16 flow against an f32 copy (the bf16 noise floor);
5. prints a {"kernels": [...]} line, then, as the last line,
   {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

adds a torch.profiler trace of one reconstruction after step 4: the
device's busy time, its idle share of the wall time and the kernels with
the most device time.

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

from taste_spokenlm_tpu_torch.config import TasteConfig
from taste_spokenlm_tpu_torch.kernels import (KERNEL_SOURCES, _build, conv1d,
                                              flash_attention, fused_dit,
                                              launch_counts,
                                              reset_launch_counts)
from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM
from taste_spokenlm_tpu_torch.ops.audio import whisper_log_mel

# NVIDIA H100 SXM data sheet (dense): HBM3 bytes/s, f32 outside the tensor
# cores, bf16 on the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

B, T_TOK, MAX_SPEECH, MEL_LEN_MAX = 1, 40, 512, 904


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of fn() after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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


def kernel_rows(cfg: TasteConfig, dev, gen, mel_len: int, n_frames: int):
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
    return rows


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
    to see."""
    near_one = set()
    for name, mod in model.named_modules():
        if isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
            near_one.add(f"{name}.weight")
    sd = {}
    for name, ref in model.state_dict().items():
        shape = ref.shape
        r = torch.randn(shape, generator=gen, device=ref.device)
        dit_matrix = (".estimator." in name and ref.dim() == 2
                      and (".attn1." in name or ".ff.net." in name))
        if name in near_one or name.endswith(".alpha"):
            v = 1.0 + 0.02 * r
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


def device_profile(model, x, gen, wall_s: float):
    """Device time of one reconstruction from a torch.profiler trace: the
    union of the CUDA kernel intervals against the unprofiled wall time,
    and the kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        reconstruct(model, x, gen)
        torch.cuda.synchronize()
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
    return {"busy_s": busy_us / 1e6, "idle_share": 1.0 - busy_us / 1e6 / wall_s,
            "n_kernel_launches": len(kernels),
            "top_kernels": [{"name": n[:90], "launches": c, "ms": us / 1e3}
                            for n, (c, us) in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one reconstruction with torch.profiler "
                         "(device busy time, idle share, top kernels; adds "
                         "about two minutes)")
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
    cfg = TasteConfig.full()
    cfg = cfg.replace(flow=cfg.flow.replace(fused_dit_serving=True),
                      hift=cfg.hift.replace(pallas_conv=True))
    t0 = time.perf_counter()
    model = TasteForCausalLM(cfg, dtype=torch.bfloat16,
                             tower_dtype=torch.float32, device=dev)
    model.load_state_dict(random_state_dict(model, gen), strict=True)
    model.eval()
    torch.cuda.synchronize()
    log({"model_init_s": time.perf_counter() - t0,
         "params": sum(p.numel() for p in model.parameters())})
    x = inputs(cfg, dev)
    n_frames = x["audio_features"].shape[-1]
    check(tuple(x["audio_features"].shape) == (B, 128, 3000),
          f"mel shape {tuple(x['audio_features'].shape)}")

    # warm-up run (cuDNN / cuBLAS plans), then the counted, timed run
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
    expected = {
        "flash_attention": sum(flash_shapes(cfg, n_frames).values()),
        "fused_dit_block": sum(dit_shapes(cfg, mel_len).values()),
        "conv1d_same": sum(conv_shapes(cfg).values())}
    for name, n in expected.items():
        check(counts[name] > 0, f"{name} never launched on the main path")
        check(counts[name] == n, f"{name}: {counts[name]} launches, the "
                                 f"config implies {n}")
    log({"reconstruction": {
        "wall_s": wall, "audio_s": audio_s, "rtf": wall / audio_s,
        "s3_decode_len": dec_len, "mel_frames": mel_len, "wav_len": wav_len,
        "peak_mem_gb": peak_gb, "launches": counts}})
    log({"stages": stage_times(model, x, out, gen)})
    if opts.profile:
        log({"device_profile": device_profile(model, x, gen, wall)})

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

    with torch.no_grad():
        rows = kernel_rows(cfg, dev, gen, mel_len, n_frames)
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
            "per": "one reconstruction: per-launch times x launches; per-shape "
                   "rows in 'shapes'",
            "shapes": shapes})
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
