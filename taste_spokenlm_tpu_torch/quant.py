"""Weight-only int8 / int4 serving layouts, as transforms of the port's state
dicts (the port's copy of the slice's parts of the JAX package's
utils/quant.py, which works on flax trees).

From the same float weights the quantized arrays are byte-identical to the
JAX package's and the scales equal: symmetric per-output-channel int8
(scale = max|w| / 127, ties rounded to even), and for the tied Llama head
the transposed table nibble-packed with group-wise int4 scales
(kernels/int4_matmul.py).  Quantized kernels are stored [in, out] as in
JAX, not transposed like a torch Linear weight.

    lm = spoken_lm.language_model                 # a float LlamaModel
    sd = merge_lora_params(lm.state_dict(), lora.alpha, lora.r)
    sd = quantize_llama_params(sd, include_embed=True,
                               embed_head_mode="int4head", fuse_qkv=True,
                               fused_mlp=True)    # -> the int8 LlamaModel's

The int4 tier (int4 projections, int4-tiled MLP packing) is ROADMAP.md
queue B.
"""

from __future__ import annotations

from typing import Dict

import torch

from taste_spokenlm_tpu_torch.kernels.int4_matmul import quantize_int4

_PROJ = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
         "down_proj")
_FUSED = {"self_attn": ("qkv_proj", ("q_proj", "k_proj", "v_proj")),
          "mlp": ("gateup_proj", ("gate_proj", "up_proj"))}
_ENCODER_DENSE = ("linear_q", "linear_k", "linear_v", "linear_out",
                  "linear_pos", "w_1", "w_2")
QUEUE_B = ("the int4 tier (QDense4, gated_mlp_int4, ffn_int4) is not ported: "
           "ROADMAP.md queue B")


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to(torch.float32)


def quantize_kernel(w, mode: str = "int8") -> Dict[str, torch.Tensor]:
    """[in, out] float kernel -> {"base_q" int8 [in, out], "base_scale" f32
    [out]}, symmetric per-output-channel scales."""
    if mode != "int8":
        raise NotImplementedError(QUEUE_B)
    w = _f32(w)
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
    """{prefix.weight [out, in], prefix.bias?} -> {prefix.kernel_q [in, out],
    prefix.scale, prefix.bias?} (ops/quantized.QDense)."""
    qd = quantize_kernel(_f32(sd[f"{prefix}.weight"]).T, mode)
    out = {f"{prefix}.kernel_q": qd["base_q"], f"{prefix}.scale": qd["base_scale"]}
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
    separate (fused_mlp_serving overrides the gateup half of fuse_qkv)."""
    if mode != "int8":
        raise NotImplementedError(QUEUE_B)
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
                    qd = quantize_kernel(kern, mode)
                    out[f"{pre}.{fused_name}.base_q"] = qd["base_q"]
                    out[f"{pre}.{fused_name}.base_scale"] = qd["base_scale"]
                continue
            qd = quantize_kernel(_f32(val).T, mode)
            base = ".".join(parts[:4])
            out[f"{base}.base_q"] = qd["base_q"]
            out[f"{base}.base_scale"] = qd["base_scale"]
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
    the QDense layout of w_1 / w_2."""
    if mode != "int8":
        raise NotImplementedError(QUEUE_B)
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
        out.update(quantize_dense_leaf(sd, base, mode))
    return out
