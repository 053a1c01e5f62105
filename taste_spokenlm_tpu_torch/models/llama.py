"""Llama-3.2 backbone with LoRA, GQA, llama3 rope scaling and the int8 /
int4 serving layouts (counterpart of the JAX models/llama.py).

State-dict names follow HF Llama (embed_tokens, layers.{i}.self_attn.q_proj,
input_layernorm, post_attention_layernorm, mlp.gate_proj/up_proj/down_proj,
norm).  A float projection holds `weight` [out, in] (and peft-shaped
`lora_A` [r, in], `lora_B` [out, r]); the int8 layout holds `base_q` [in,
out] and `base_scale` [out], the int4 layout `base_q4` [in/2, out]
(nibble-packed) and `base_scale` [in/g, out], run through the int4 kernel
(kernels/int4_matmul.py).  The serving flags of LlamaConfig pick the
layout: `quantized_serving` "int8" or "int4", `fused_qkv_serving` one
qkv_proj (and gateup_proj), `fused_mlp_serving` the whole MLP as one kernel
call (kernels/fused_mlp.py; int4 packs down_proj per tile), and
`quantized_embed_serving` an int8 table whose "int4head" tied head runs the
int4 kernel.  KV caches are written in place.

Built with a `model_axis` (parallel/mesh.py `ModelAxis`) the Llama is
split over the model group as JAX's `_TP_RULES` shard it: each rank holds
its block of the query heads and their GQA key / value heads (q / k / v and
gate / up by their output columns, o / down by their input rows, their
partial products summed over the group), its block of the vocab's
embedding rows, and a cache of its key / value heads.  What JAX's rule
leaves whole, or what a rank needs whole, is held whole and computed alike
on every rank: the fused qkv_proj / gateup_proj (the rank slices its heads
out of the product), the int4 projections (base_q4 has no rule), LoRA's
adapters (a rank reads its block of them), the norms, the untied head and
the int4 tied head.  The float and int8 tied heads multiply by the rank's
vocab rows and gather the vocab axis, so every rank ends with the same
logits.  `quant.shard_state_dict` cuts a full state dict to a rank's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from taste_spokenlm_tpu_torch.config import LlamaConfig, LoraConfig
from taste_spokenlm_tpu_torch.ops.attention import gqa_attention
from taste_spokenlm_tpu_torch.ops.quantized import (F32Buffers, QEmbed,
                                                    fused_gated_mlp_apply,
                                                    int4_apply,
                                                    int4_param_shapes, qmode)
from taste_spokenlm_tpu_torch.ops.remat import call_layer
from taste_spokenlm_tpu_torch.parallel import mesh

NEG_F32 = torch.finfo(torch.float32).min / 2


class LoraDense(F32Buffers):
    """y = x W (+ b) + (alpha / r) (x A) B, or with `quantized` the int8
    base (x @ base_q) * base_scale or the int4 base x @ dequant(base_q4,
    base_scale) (the int4 kernel, its plain version when `use_kernels` is
    False), computed in the input's dtype.

    `split` over a `model_axis`: "column" holds the rank's block of the
    output features (y is the rank's block), "row" the rank's block of the
    input features (x is the rank's block; the partial products, LoRA's
    with the base's, are summed over the model group).  An int4 base is
    held whole (JAX's rule has no base_q4), and LoRA's A and B are held
    whole (JAX's neither): the rank reads its block of them, and their
    gradient is summed over the group."""

    def __init__(self, in_dim: int, features: int,
                 lora: Optional[LoraConfig] = None, use_bias: bool = False,
                 quantized=False, split: Optional[str] = None,
                 model_axis: Optional[mesh.ModelAxis] = None):
        super().__init__()
        self.mode = qmode(quantized)
        self.quantized = self.mode is not None
        if self.quantized and use_bias:
            raise ValueError("LoraDense(quantized) has no bias")
        if model_axis is None or self.mode == "int4":
            split = None
        if split not in (None, "column", "row"):
            raise ValueError(f"split {split!r}")
        if split and use_bias:
            raise ValueError("a split LoraDense has no bias")
        self.in_dim, self.split = in_dim, split
        self.model_axis = model_axis if split else None
        full_in, full_out = in_dim, features
        if split:
            k = model_axis.size
            n = features if split == "column" else in_dim
            if n % k:
                raise ValueError(f"{n} features do not split over {k} ranks")
            if split == "column":
                features //= k
            else:
                in_dim //= k
        if self.mode == "int4":
            self.use_kernels = True
            wp_shape, s_shape = int4_param_shapes(in_dim, features)
            self.register_buffer("base_q4", torch.zeros(wp_shape,
                                                        dtype=torch.uint8))
            self.register_buffer("base_scale", torch.ones(s_shape))
        elif self.quantized:
            self.register_buffer("base_q", torch.zeros(in_dim, features,
                                                       dtype=torch.int8))
            self.register_buffer("base_scale", torch.ones(features))
        else:
            self.weight = nn.Parameter(torch.empty(features, in_dim))
            self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
            nn.init.normal_(self.weight, std=full_in ** -0.5)
        self.lora = lora if lora is not None and lora.r > 0 else None
        if self.lora is not None:
            bound = math.sqrt(1.0 / full_in)
            self.lora_A = nn.Parameter(torch.empty(self.lora.r, full_in)
                                       .uniform_(-bound, bound))
            self.lora_B = nn.Parameter(torch.zeros(full_out, self.lora.r))

    def forward(self, x: torch.Tensor, disable_lora: bool = False
                ) -> torch.Tensor:
        """`disable_lora`: the base projection alone (the frozen-base
        forward of the stage-2 KL), on the same weight tensors.  LoRA
        dropout is never applied: JAX's `deterministic` defaults to True
        and no caller changes it."""
        if self.mode == "int4":
            y = int4_apply(x, self.base_q4, self.base_scale, x.dtype,
                           self.use_kernels)
        elif self.quantized:
            dt = x.dtype
            y = (x @ self.base_q.to(dt)) * self.base_scale.to(dt)
        else:
            y = F.linear(x.to(self.weight.dtype), self.weight, self.bias)
        if self.lora is not None and not disable_lora:
            a, b, axis = self.lora_A, self.lora_B, self.model_axis
            if axis is not None:
                a, b = mesh.copy_to_model(a, axis), mesh.copy_to_model(b, axis)
                if self.split == "column":
                    b = b[axis.part(b.shape[0])]
                else:
                    a = a[:, axis.part(a.shape[1])]
            h = (x.float() @ a.float().T) @ b.float().T
            y = y + (self.lora.alpha / self.lora.r) * h.to(y.dtype)
        if self.split == "row":
            y = mesh.reduce_from_model(y, self.model_axis)
        return y


class _Bf16Head(torch.autograd.Function):
    """hidden [..., H] x bf16 table [V, H] -> f32 logits [..., V] on the
    tensor cores: bf16 operands, f32 sums and output (cuBLAS through
    `torch.mm(out_dtype=)`), the numerics of JAX's head (bf16 operands,
    preferred_element_type f32) without an f32 copy of the table.  The
    backward is the f32 head's: f32 products against the table in f32,
    each gradient rounded to its input's dtype."""

    @staticmethod
    def forward(ctx, hidden, w):
        x = hidden.to(w.dtype)
        ctx.save_for_backward(x, w)
        ctx.hidden_dtype = hidden.dtype
        out = torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.reshape(-1, w.shape[0])
        grad_x = grad_w = None
        if ctx.needs_input_grad[0]:
            grad_x = (g @ w.float()).reshape(x.shape).to(x.dtype).to(
                ctx.hidden_dtype)
        if ctx.needs_input_grad[1]:
            grad_w = (g.t() @ x.reshape(-1, x.shape[-1]).float()).to(w.dtype)
        return grad_x, grad_w


def llama3_inv_freq(cfg: LlamaConfig) -> np.ndarray:
    """Rope inverse frequencies with llama3 frequency-dependent scaling."""
    head_dim = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                                    / head_dim))
    factor = cfg.rope_scaling_factor
    low_wavelen = cfg.rope_original_max_position / cfg.rope_low_freq_factor
    high_wavelen = cfg.rope_original_max_position / cfg.rope_high_freq_factor
    wavelen = 2 * np.pi / inv
    scaled = np.where(wavelen > low_wavelen, inv / factor, inv)
    smooth = (cfg.rope_original_max_position / wavelen - cfg.rope_low_freq_factor) / (
        cfg.rope_high_freq_factor - cfg.rope_low_freq_factor)
    mid = (1 - smooth) * inv / factor + smooth * inv
    is_mid = (wavelen >= high_wavelen) & (wavelen <= low_wavelen)
    return np.where(is_mid, mid, scaled).astype(np.float32)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [B, T, H, D]; cos/sin [T, D/2] or [B, T, D/2]; rotate-half (HF)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        normed = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + self.eps)
        return (self.weight.float() * normed).to(self.weight.dtype)


def local_heads(cfg: LlamaConfig, model_axis: Optional[mesh.ModelAxis]):
    """(query heads, key / value heads) a rank holds: its block of each."""
    k = 1 if model_axis is None else model_axis.size
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    if nh % k or nkv % k:
        raise ValueError(f"{nh} query and {nkv} key / value heads do not "
                         f"split over {k} model ranks")
    return nh // k, nkv // k


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, lora: Optional[LoraConfig] = None,
                 model_axis: Optional[mesh.ModelAxis] = None):
        super().__init__()
        self.cfg = cfg
        self.model_axis = model_axis
        self.heads = local_heads(cfg, model_axis)
        hd, qz = cfg.head_dim, cfg.quantized_serving
        h = cfg.hidden_size
        column = dict(quantized=qz, split="column", model_axis=model_axis)
        if cfg.fused_qkv_serving:
            if lora is not None:
                raise ValueError("fused_qkv_serving needs merged LoRA "
                                 "(use_lora=False)")
            self.qkv_proj = LoraDense(
                h, (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * hd,
                quantized=qz)
        else:
            self.q_proj = LoraDense(h, cfg.num_attention_heads * hd, lora,
                                    **column)
            self.k_proj = LoraDense(h, cfg.num_key_value_heads * hd, lora,
                                    **column)
            self.v_proj = LoraDense(h, cfg.num_key_value_heads * hd, lora,
                                    **column)
        self.o_proj = LoraDense(cfg.num_attention_heads * hd, h, lora,
                                quantized=qz, split="row",
                                model_axis=model_axis)

    def forward(self, x, cos, sin, mask=None, cache=None, cache_index: int = 0,
                disable_lora: bool = False):
        cfg, axis = self.cfg, self.model_axis
        b, t, _ = x.shape
        hd, nh, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
        nh_l, nkv_l = self.heads
        x = mesh.copy_to_model(x, axis)
        if cfg.fused_qkv_serving:
            qkv = self.qkv_proj(x)
            q, k, v = qkv.split([nh * hd, nkv * hd, nkv * hd], dim=-1)
        else:
            q, k, v = (p(x, disable_lora)
                       for p in (self.q_proj, self.k_proj, self.v_proj))
        if axis is not None:
            # a product held whole: the rank's block of its heads
            q, k, v = (y if y.shape[-1] == n * hd
                       else y[..., axis.part(y.shape[-1])]
                       for y, n in ((q, nh_l), (k, nkv_l), (v, nkv_l)))
        q = apply_rope(q.reshape(b, t, nh_l, hd), cos, sin)
        k = apply_rope(k.reshape(b, t, nkv_l, hd), cos, sin)
        v = v.reshape(b, t, nkv_l, hd)
        if cache is not None:
            cache["k"][:, cache_index:cache_index + t] = k
            cache["v"][:, cache_index:cache_index + t] = v
            k, v = cache["k"], cache["v"]
        out = gqa_attention(q, k, v, mask).reshape(b, t, nh_l * hd)
        if axis is not None and self.o_proj.split is None:
            out = mesh.gather_from_model(out, axis)
        return self.o_proj(out, disable_lora)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, lora: Optional[LoraConfig] = None,
                 model_axis: Optional[mesh.ModelAxis] = None):
        super().__init__()
        h, i, qz = cfg.hidden_size, cfg.intermediate_size, cfg.quantized_serving
        self.model_axis = model_axis
        self.fused_mlp = bool(cfg.fused_mlp_serving and qmode(qz))
        self.use_kernels = True     # False: the fused MLP's plain version
        self.gateup = cfg.fused_qkv_serving and not self.fused_mlp
        if (self.fused_mlp or self.gateup) and lora is not None:
            raise ValueError("fused serving layouts need merged LoRA "
                             "(use_lora=False)")
        column = dict(quantized=qz, split="column", model_axis=model_axis)
        if self.gateup:
            self.gateup_proj = LoraDense(h, 2 * i, quantized=qz)
        else:
            self.gate_proj = LoraDense(h, i, lora, **column)
            self.up_proj = LoraDense(h, i, lora, **column)
        self.down_proj = LoraDense(i, h, lora, quantized=qz, split="row",
                                   model_axis=model_axis)

    def forward(self, x: torch.Tensor, disable_lora: bool = False
                ) -> torch.Tensor:
        axis, down = self.model_axis, self.down_proj
        x = mesh.copy_to_model(x, axis)
        if self.fused_mlp:
            mode = down.mode
            w = "base_q4" if mode == "int4" else "base_q"
            pair = lambda m: (getattr(m, w), m.base_scale)  # noqa: E731
            # int8 over a model axis: the kernel on the rank's block of the
            # intermediate axis, its partial output summed over the group
            out = fused_gated_mlp_apply(x, pair(self.gate_proj),
                                        pair(self.up_proj), pair(down), mode,
                                        x.dtype, use_kernel=self.use_kernels)
            return (mesh.reduce_from_model(out, axis) if down.split
                    else out)
        if self.gateup:
            gate, up = self.gateup_proj(x).chunk(2, dim=-1)
        else:
            gate = self.gate_proj(x, disable_lora)
            up = self.up_proj(x, disable_lora)
        act = F.silu(gate) * up
        if down.split and act.shape[-1] == down.in_dim:
            act = act[..., axis.part(act.shape[-1])]   # gateup held whole
        return down(act, disable_lora)


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, lora: Optional[LoraConfig] = None,
                 model_axis: Optional[mesh.ModelAxis] = None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg, lora, model_axis)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg, lora, model_axis)

    def forward(self, x, cos, sin, mask=None, cache=None, cache_index: int = 0,
                disable_lora: bool = False):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, mask, cache,
                               cache_index, disable_lora)
        return x + self.mlp(self.post_attention_layernorm(x), disable_lora)


class VocabEmbedding(nn.Embedding):
    """The rank's block of the vocab's rows of an embedding table: a lookup
    reads the ids in its block, zeros the others, and sums over the model
    group."""

    def __init__(self, num_embeddings: int, dim: int,
                 model_axis: mesh.ModelAxis):
        super().__init__(num_embeddings // model_axis.size, dim)
        self.model_axis = model_axis
        self.offset = model_axis.rank * self.num_embeddings

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        local = ids - self.offset
        own = (local >= 0) & (local < self.num_embeddings)
        out = F.embedding(torch.where(own, local, torch.zeros_like(local)),
                          self.weight)
        out = torch.where(own[..., None], out, torch.zeros_like(out))
        return mesh.reduce_from_model(out, self.model_axis)


class LlamaModel(nn.Module):
    """The backbone; the head is tied to embed_tokens unless the config
    unties it (then `lm_head.weight` [V, H]).  `model_axis`: split over a
    model group (the module docstring)."""

    def __init__(self, cfg: LlamaConfig, lora: Optional[LoraConfig] = None,
                 dtype: torch.dtype = torch.float32,
                 model_axis: Optional[mesh.ModelAxis] = None):
        super().__init__()
        self.config, self.dtype = cfg, dtype
        self.model_axis = model_axis
        # the vocab axis splits where it divides (JAX's rule), else whole
        vocab_axis = (model_axis if model_axis is not None
                      and cfg.vocab_size % model_axis.size == 0 else None)
        self.vocab_axis = vocab_axis
        if cfg.quantized_embed_serving:
            head = "int4" if cfg.quantized_embed_serving == "int4head" else "int8"
            self.embed_tokens = QEmbed(cfg.vocab_size, cfg.hidden_size, dtype,
                                       head_mode=head, model_axis=vocab_axis)
        elif vocab_axis is not None:
            self.embed_tokens = VocabEmbedding(cfg.vocab_size,
                                               cfg.hidden_size, vocab_axis)
        else:
            self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(LlamaLayer(cfg, lora, model_axis)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        self.register_buffer("inv_freq", torch.from_numpy(llama3_inv_freq(cfg)),
                             persistent=False)
        self.to(dtype)
        self.inv_freq = self.inv_freq.float()

    def _rope(self, positions: torch.Tensor):
        freqs = positions.float()[..., None] * self.inv_freq.float()
        return torch.cos(freqs).to(self.dtype), torch.sin(freqs).to(self.dtype)

    def forward(self, input_ids=None, inputs_embeds=None,
                attention_lengths=None, position_offset=0, caches=None,
                cache_index: int = 0, output_hidden_states: bool = False,
                key_valid=None, disable_lora: bool = False) -> Dict:
        """Full sequence (caches None: causal, optionally length-masked) or
        cached (rows written at `cache_index`, attending to cache slots up
        to their own and to `key_valid` [B, Tk]).  `position_offset` is a
        scalar or per-row [B] rope offset.  `disable_lora` runs the base
        weights alone.  Each layer is checkpointed when the config's
        `remat` is on and autograd records (ops/remat.py)."""
        if inputs_embeds is None:
            inputs_embeds = self.embed_tokens(input_ids)
        x = inputs_embeds.to(self.dtype)
        b, t, _ = x.shape
        dev = x.device
        ar = torch.arange(t, device=dev)
        off = torch.as_tensor(position_offset, device=dev)
        positions = ar + off if off.dim() == 0 else off[:, None] + ar[None, :]
        cos, sin = self._rope(positions)
        if caches is None:
            mask = torch.ones((t, t), dtype=torch.bool, device=dev).tril()[None, None]
            if attention_lengths is not None:
                valid = ar[None, :] < attention_lengths.to(dev)[:, None]
                mask = mask & valid[:, None, None, :]
        else:
            tk = caches[0]["k"].shape[1]
            q_pos = cache_index + ar[None, None, :, None]
            mask = torch.arange(tk, device=dev)[None, None, None, :] <= q_pos
            if key_valid is not None:
                mask = mask & key_valid[:, None, None, :]
        hidden = [x] if output_hidden_states else None
        for i, layer in enumerate(self.layers):
            x = call_layer(layer, self.config.remat, x, cos, sin, mask,
                           None if caches is None else caches[i], cache_index,
                           disable_lora=disable_lora)
            if output_hidden_states:
                hidden.append(x)
        x = self.norm(x)
        out = {"last_hidden": x}
        if output_hidden_states:
            hidden[-1] = x        # HF: the last entry is the post-norm state
            out["hidden_states"] = tuple(hidden)
        if caches is not None:
            out["caches"] = caches
        return out

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """The head, f32 logits: bf16 operands with f32 sums.  A bf16
        table on a CUDA device runs as one bf16 cuBLAS product with f32
        output (`_Bf16Head`, no f32 copy of the table); any other as an
        f32 product over the table in f32; the int8 / int4 tied head
        through QEmbed.  Over a model axis the tied head multiplies by the
        rank's vocab rows and gathers the vocab axis: every rank gets the
        same full logits."""
        axis = None
        if not self.config.tie_word_embeddings:
            w = self.lm_head.weight
        elif self.config.quantized_embed_serving:
            return self.embed_tokens.logits(hidden)
        else:
            w, axis = self.embed_tokens.weight, self.vocab_axis
        hidden = mesh.copy_to_model(hidden, axis)
        if w.dtype == torch.bfloat16 and w.is_cuda:
            out = _Bf16Head.apply(hidden, w)
        else:
            out = hidden.to(w.dtype).float() @ w.float().T
        return mesh.gather_from_model(out, axis)

    def init_cache(self, batch: int, max_len: int) -> List[Dict[str, torch.Tensor]]:
        cfg = self.config
        dev = self.norm.weight.device
        shape = (batch, max_len, local_heads(cfg, self.model_axis)[1],
                 cfg.head_dim)
        return [{"k": torch.zeros(shape, dtype=self.dtype, device=dev),
                 "v": torch.zeros(shape, dtype=self.dtype, device=dev)}
                for _ in range(cfg.num_hidden_layers)]
