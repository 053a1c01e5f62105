"""Weight-only int8 / int4 serving layouts, as transforms of the port's state
dicts (the port's copy of the JAX package's utils/quant.py, which works on
flax trees).

From the same float weights the quantized arrays are byte-identical to the
JAX package's and the scales equal: symmetric per-output-channel int8
(scale = max|w| / 127, ties rounded to even); int4 nibble-packed along the
contraction with group-wise scales (kernels/int4_matmul.py), also for the
transposed table of the tied Llama head; and, for the second projection of
a fused int4 MLP, the same packed per tile of the fused kernel
(kernels/fused_mlp.py, `quantize_int4_tiled`).  Quantized kernels are
stored [in, out] as in JAX, not transposed like a torch Linear weight.

    lm = spoken_lm.language_model                 # a float LlamaModel
    sd = merge_lora_params(lm.state_dict(), lora.alpha, lora.r)
    sd = quantize_llama_params(sd, include_embed=True, mode="int4",
                               embed_head_mode="int4head", fuse_qkv=True,
                               fused_mlp=True)    # -> the int4 LlamaModel's

`shard_state_dict` cuts any of these state dicts (float, int8, int4, a
whole TasteForCausalLM's or a bare LlamaModel's) to a model rank's slices.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from taste_spokenlm_tpu_torch.kernels.fused_mlp import (
    dequantize_int4_tiled, mlp_tile, quantize_int4_tiled)
from taste_spokenlm_tpu_torch.kernels.int4_matmul import (dequantize_int4,
                                                          quantize_int4)
from taste_spokenlm_tpu_torch.parallel import mesh

_PROJ = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
         "down_proj")
_FUSED = {"self_attn": ("qkv_proj", ("q_proj", "k_proj", "v_proj")),
          "mlp": ("gateup_proj", ("gate_proj", "up_proj"))}
_ENCODER_DENSE = ("linear_q", "linear_k", "linear_v", "linear_out",
                  "linear_pos", "w_1", "w_2")


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to(torch.float32)


def quantize_kernel(w, mode: str = "int8") -> Dict[str, torch.Tensor]:
    """[in, out] float kernel -> the weight-only layout: int8 {"base_q" int8
    [in, out], "base_scale" f32 [out]} (per-output-channel scales); int4
    {"base_q4" uint8 [in/2, out], "base_scale" f32 [in/g, out]}
    (group-wise); int4_tiled the same shapes packed per mlp_tile(in) rows,
    for the second projection of a fused int4 MLP."""
    w = _f32(w)
    if mode in ("int4", "int4_tiled"):
        packed, scale = (quantize_int4(w) if mode == "int4"
                         else quantize_int4_tiled(w, mlp_tile(w.shape[0])))
        return {"base_q4": packed, "base_scale": scale}
    if mode != "int8":
        raise ValueError(f"quantization mode {mode!r}")
    scale = torch.clamp(w.abs().amax(dim=0), min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return {"base_q": q, "base_scale": scale}


def quantize_embed(table, head_mode: str = "int8") -> Dict[str, torch.Tensor]:
    """[V, H] table -> {"embedding_q" int8, "embedding_scale" f32 [V]}
    (per-row scales); head_mode "int4" (the "int4head" serving flag) adds
    the transposed nibble-packed head {"head_q4" uint8 [H/2, V],
    "head_scale4" f32 [H/g, V]}."""
    w = _f32(table)
    scale = torch.clamp(w.abs().amax(dim=1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    out = {"embedding_q": q, "embedding_scale": scale}
    if head_mode in ("int4", "int4head"):
        out["head_q4"], out["head_scale4"] = quantize_int4(w.T.contiguous())
    elif head_mode not in ("int8", True):
        raise ValueError(f"embed head mode {head_mode!r}")
    return out


def quantize_dense_leaf(sd: Dict, prefix: str, mode: str = "int8") -> Dict:
    """{prefix.weight [out, in], prefix.bias?} -> {prefix.kernel_q [in, out]
    (int8) or prefix.kernel_q4 (int4, int4_tiled), prefix.scale,
    prefix.bias?} (ops/quantized.QDense / QDense4)."""
    qd = quantize_kernel(_f32(sd[f"{prefix}.weight"]).T, mode)
    q = "q4" if "base_q4" in qd else "q"
    out = {f"{prefix}.kernel_{q}": qd[f"base_{q}"],
           f"{prefix}.scale": qd["base_scale"]}
    if f"{prefix}.bias" in sd:
        out[f"{prefix}.bias"] = _f32(sd[f"{prefix}.bias"])
    return out


def merge_lora_params(sd: Dict, alpha: int, r: int) -> Dict:
    """A float LlamaModel state dict with LoRA adapters -> the same without
    them, each merged into its base: W' = W + (alpha / r) A B in the [in,
    out] layout (peft `merge_and_unload`).  Serving-only; pair with
    use_lora=False and quantize the merged dict."""
    scale = alpha / r
    out = {k: v for k, v in sd.items() if not k.endswith((".lora_A", ".lora_B"))}
    for key, a in sd.items():
        if not key.endswith(".lora_A"):
            continue
        base = key[: -len(".lora_A")]
        if f"{base}.weight" not in sd:
            raise KeyError(f"{base}: merge_lora_params runs on the float "
                           "state dict (before quantize_llama_params)")
        a = _f32(a).T                                # [in, r]
        b = _f32(sd[f"{base}.lora_B"]).T             # [r, out]
        if a.shape[1] != r:
            raise ValueError(f"{base}: adapter rank {a.shape[1]} != {r}")
        k = _f32(sd[f"{base}.weight"]).T
        out[f"{base}.weight"] = (k + scale * (a @ b)).T.contiguous()
    return out


def quantize_llama_params(sd: Dict, include_embed: bool = False,
                          mode: str = "int8", embed_head_mode: str = "int8",
                          fuse_qkv: bool = False, fused_mlp: bool = False
                          ) -> Dict:
    """A float LlamaModel state dict (merged adapters) -> the
    quantized_serving layout: each projection's `weight` becomes `base_q` /
    `base_scale`.  `include_embed` also quantizes embed_tokens (the tied
    head) for quantized_embed_serving; `fuse_qkv` emits `qkv_proj` and
    `gateup_proj` (fused_qkv_serving); `fused_mlp` keeps gate / up / down
    separate (fused_mlp_serving overrides the gateup half of fuse_qkv) and,
    in int4, packs down_proj per tile.  `mode` "int4" stores `base_q4` and
    group-wise `base_scale` instead."""
    if any(k.endswith(".lora_A") for k in sd):
        raise ValueError("quantize_llama_params needs merged LoRA "
                         "(merge_lora_params first)")
    out: Dict = {}
    for key, val in sd.items():
        parts = key.split(".")
        if key == "embed_tokens.weight" and include_embed:
            out.update({f"embed_tokens.{k}": v for k, v in
                        quantize_embed(val, embed_head_mode).items()})
        elif len(parts) == 5 and parts[0] == "layers" and parts[3] in _PROJ \
                and parts[4] == "weight":
            fused_name, members = _FUSED[parts[2]]
            fuse = fuse_qkv and not (fused_mlp and parts[2] == "mlp")
            if fuse and parts[3] in members:
                if parts[3] == members[0]:
                    pre = ".".join(parts[:3])
                    kern = torch.cat([_f32(sd[f"{pre}.{n}.weight"]).T
                                      for n in members], dim=1)
                    out.update({f"{pre}.{fused_name}.{k}": v for k, v in
                                quantize_kernel(kern, mode).items()})
                continue
            tiled = fused_mlp and mode == "int4" and parts[3] == "down_proj"
            out.update({f"{'.'.join(parts[:4])}.{k}": v for k, v in
                        quantize_kernel(_f32(val).T, "int4_tiled" if tiled
                                        else mode).items()})
        else:
            out[key] = val
    return out


def quantize_encoder_params(sd: Dict, mode: str = "int8",
                            fuse_qkv: bool = False, fused_mlp: bool = False
                            ) -> Dict:
    """A float ConformerEncoder state dict -> the quantized_serving layout:
    each layer's attention and FFN Linears become QDense (`kernel_q`,
    `scale`, `bias`); `fuse_qkv` concatenates linear_q/k/v into one
    `linear_qkv` (kernels, biases and per-channel scales concatenate
    losslessly).  `fused_mlp` changes nothing in int8: the fused FFN reads
    the QDense layout of w_1 / w_2; in int4 it packs w_2 per tile.  `mode`
    "int4" gives the QDense4 layout (`kernel_q4`, group-wise `scale`)."""
    out: Dict = {}
    done = set()
    for key, val in sd.items():
        parts = key.split(".")
        if not (len(parts) == 5 and parts[0] == "encoders"
                and parts[3] in _ENCODER_DENSE):
            out[key] = val
            continue
        base = ".".join(parts[:4])
        if base in done:
            continue
        done.add(base)
        pre = ".".join(parts[:3])
        if fuse_qkv and parts[3] in ("linear_q", "linear_k", "linear_v"):
            names = ("linear_q", "linear_k", "linear_v")
            fused = {"linear_qkv.weight": torch.cat(
                [_f32(sd[f"{pre}.{n}.weight"]) for n in names], dim=0)}
            if f"{pre}.linear_q.bias" in sd:
                fused["linear_qkv.bias"] = torch.cat(
                    [_f32(sd[f"{pre}.{n}.bias"]) for n in names], dim=0)
            out.update({f"{pre}.{k}": v for k, v in
                        quantize_dense_leaf(fused, "linear_qkv", mode).items()})
            done.update(f"{pre}.{n}" for n in names)
            continue
        tiled = fused_mlp and mode == "int4" and parts[3] == "w_2"
        out.update(quantize_dense_leaf(sd, base, "int4_tiled" if tiled else mode))
    return out


def serving_config(cfg, tier: str):
    """The serving layout of a float TasteConfig in `tier` ("int8" or
    "int4"), as bench.py:755-811 builds it with BENCH_FUSED_MLP=1 (and
    BENCH_QUANT=4 for int4): LoRA merged, the Llama in the tier with the
    int4 tied head, fused qkv and fused MLPs, the S3 llm stack likewise,
    fused DiT blocks and the kernel convs."""
    sd, lm = cfg.speech_decoder, cfg.spoken_lm
    return cfg.replace(
        flow=cfg.flow.replace(fused_dit_serving=True),
        hift=cfg.hift.replace(pallas_conv=True),
        spoken_lm=lm.replace(use_lora=False, llama=lm.llama.replace(
            quantized_serving=tier, quantized_embed_serving="int4head",
            fused_qkv_serving=True, fused_mlp_serving=True)),
        speech_decoder=sd.replace(llm=sd.llm.replace(
            quantized_serving=tier, fused_qkv_serving=True,
            fused_mlp_serving=True)))


def serving_state_dict(sd: Dict, cfg, tier: str) -> Dict:
    """The float TasteForCausalLM's state dict -> the layout of
    serving_config(., tier) (`cfg`): LoRA merged, the Llama in the tier
    with the int4 tied head, fused qkv and separate MLP projections (int4:
    down_proj packed per tile); the S3 llm stack (int4: w_2 per tile) and
    its head likewise; every other entry as it is."""
    lm_pre, llm_pre = "spoken_lm.language_model.", "speech_decoder.llm."
    head = "speech_decoder.llm_decoder"
    sub = lambda pre: {k[len(pre):]: v for k, v in sd.items()  # noqa: E731
                       if k.startswith(pre)}
    lora = cfg.spoken_lm.lora
    lm = quantize_llama_params(
        merge_lora_params(sub(lm_pre), lora.alpha, lora.r),
        include_embed=True, mode=tier, embed_head_mode="int4head",
        fuse_qkv=True, fused_mlp=True)
    enc = quantize_encoder_params(sub(llm_pre), mode=tier, fuse_qkv=True,
                                  fused_mlp=True)
    out = {k: v for k, v in sd.items()
           if not k.startswith((lm_pre, llm_pre, head + "."))}
    out.update({lm_pre + k: v for k, v in lm.items()})
    out.update({llm_pre + k: v for k, v in enc.items()})
    out.update(quantize_dense_leaf(sd, head, tier))
    return out


def float_layout_config(cfg):
    """The float config whose state dict dequantized_state_dict(., cfg)
    fills: `cfg` with nothing quantized, fused or run by a kernel, and the
    Llama's head untied where the layout stores the tied table twice (an
    int8 embedding table and an int4 head)."""
    sd, lm = cfg.speech_decoder, cfg.spoken_lm
    llama = lm.llama
    return cfg.replace(
        flow=cfg.flow.replace(fused_dit_serving=False),
        hift=cfg.hift.replace(pallas_conv=False),
        spoken_lm=lm.replace(llama=llama.replace(
            quantized_serving=False, quantized_embed_serving=False,
            fused_qkv_serving=False, fused_mlp_serving=False,
            tie_word_embeddings=(llama.tie_word_embeddings
                                 and not llama.quantized_embed_serving))),
        speech_decoder=sd.replace(llm=sd.llm.replace(
            quantized_serving=False, fused_qkv_serving=False,
            fused_mlp_serving=False)))


def dequantized_state_dict(sd: Dict, cfg) -> Dict:
    """A state dict in the layout of `cfg` (a serving_config, or a float
    config) -> the f32 state dict of float_layout_config(cfg) holding the
    same weights: each quantized kernel the float matrix it stands for
    (int8 per channel, int4 per group and, for a fused MLP's second
    projection, per tile), fused qkv kernels and biases split, the int8
    embedding table and the int4 head apart; every other float entry cast
    to f32."""
    llama = cfg.spoken_lm.llama
    q_out = llama.num_attention_heads * llama.head_dim
    kv_out = llama.num_key_value_heads * llama.head_dim
    splits = {"qkv_proj": (("q_proj", "k_proj", "v_proj"),
                           (q_out, kv_out, kv_out)),
              "linear_qkv": (("linear_q", "linear_k", "linear_v"), None)}
    out: Dict = {}

    def put(pre: str, leaf: str, t: torch.Tensor) -> None:
        base, _, name = pre.rpartition(".")
        if name not in splits:
            out[f"{pre}.{leaf}"] = t.contiguous()
            return
        names, sizes = splits[name]
        parts = t.split(sizes) if sizes else t.chunk(len(names))
        for n, part in zip(names, parts):
            out[f"{base}.{n}.{leaf}"] = part.contiguous()

    kernels = ("base_q", "base_q4", "kernel_q", "kernel_q4")
    scale_of = lambda pre, leaf: (  # noqa: E731
        f"{pre}.{'base_scale' if leaf[0] == 'b' else 'scale'}")
    used = {scale_of(*k.rpartition(".")[::2]) for k in sd
            if k.rpartition(".")[2] in kernels}
    for key, val in sd.items():
        pre, _, leaf = key.rpartition(".")
        if leaf in kernels:
            scale = sd[scale_of(pre, leaf)]
            if not leaf.endswith("q4"):
                w = val.float() * scale.float()[None, :]
            elif pre.endswith(("mlp.down_proj", "feed_forward.w_2")):
                w = dequantize_int4_tiled(val, scale, mlp_tile(2 * val.shape[0]))
            else:
                w = dequantize_int4(val, scale)
            put(pre, "weight", w.T)
        elif key in used or leaf in ("embedding_scale", "head_scale4"):
            continue
        elif leaf == "embedding_q":
            out[f"{pre}.weight"] = (val.float()
                                    * sd[f"{pre}.embedding_scale"][:, None])
        elif leaf == "head_q4":
            head = pre.rpartition(".")[0] + ".lm_head.weight"
            out[head] = dequantize_int4(val, sd[f"{pre}.head_scale4"]).T \
                .contiguous()
        elif leaf == "bias" and pre.endswith("linear_qkv"):
            put(pre, "bias", val.float())
        else:
            out[key] = val.float() if val.is_floating_point() else val
    return out


def shard_state_dict(sd: Dict, model_rank: int, model_size: int) -> Dict:
    """A full state dict (torch tensors or numpy arrays) -> model rank
    `model_rank` of `model_size`'s: each tensor that JAX's `_TP_RULES` split
    and the port does not hold whole (parallel/mesh.py `tp_axis`) sliced to
    the rank's block of its axis (a contiguous copy), the others as they
    are.  It loads strictly into the module built with that rank's
    ModelAxis; the ranks' slices, concatenated in rank order, are the
    input."""
    if model_size == 1:
        return dict(sd)
    part = mesh.ModelAxis(model_rank, model_size).part
    out: Dict = {}
    for key, val in sd.items():
        axis = mesh.tp_axis(key, tuple(val.shape), model_size)
        if axis is None:
            out[key] = val
            continue
        idx = [slice(None)] * val.ndim
        idx[axis] = part(val.shape[axis])
        piece = val[tuple(idx)]
        out[key] = (piece.contiguous().clone() if isinstance(piece, torch.Tensor)
                    else np.ascontiguousarray(piece))
    return out
