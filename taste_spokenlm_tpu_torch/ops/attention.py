"""Attention cores (counterpart of the JAX ops/attention.py:
`multi_head_attention`, `padded_flash_attention` and `gqa_attention`)."""

from __future__ import annotations

from typing import Optional

import torch

from taste_spokenlm_tpu_torch.kernels.flash_attention import flash_attention

NEG_F32 = torch.finfo(torch.float32).min / 2


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         mask: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Tq, H, D], k/v [B, Tk, H, D] -> [B, Tq, H, D].

    Logits and softmax in fp32 whatever the input dtype; the probabilities
    are cast back to the input dtype before the value product, as in JAX.
    `mask` is bool, broadcastable to [B, H, Tq, Tk]."""
    dtype = q.dtype
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = torch.where(mask, logits, logits.new_tensor(NEG_F32))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype).float(), v.float())
    return out.to(dtype)


def padded_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_valid: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Attention with a per-row key padding mask, on the flash kernel.

    `key_valid` bool [B, Tk] must be a prefix mask (row b's valid keys are
    0 .. n_b - 1), as the flow's frame mask is: on a CUDA tensor it becomes
    the kernel's `kv_lengths` (kernels/flash_attention.py), so head dims
    are the kernel's (32, 64, 128), not JAX's D + 1 mask lane.  On a CPU
    tensor it is the plain masked attention on the mask itself.  A row with
    no valid key gets a finite average of its values, where JAX returns a
    uniform softmax over junk; callers mask such rows (the U-Net
    multiplies by the frame mask)."""
    if q.device.type == "cpu":
        return multi_head_attention(q, k, v, mask=key_valid[:, None, None, :],
                                    scale=scale)
    lengths = key_valid.sum(dim=-1).to(torch.int32)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           scale=scale, kv_lengths=lengths)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention (Llama-3), fp32 softmax: q [B, Tq, Hq, D],
    k/v [B, Tk, Hkv, D] (Hq a multiple of Hkv), `mask` bool broadcastable
    to [B, 1 or Hq, Tq, Tk] -> [B, Tq, Hq, D]."""
    b, tq, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    qg = q.reshape(b, tq, hkv, group, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if mask is not None:
        if mask.dim() == 4:     # [B, 1|H, Tq, Tk] -> [B, Hkv|1, g|1, Tq, Tk]
            mask = (mask[:, :, None] if mask.shape[1] == 1
                    else mask.reshape(mask.shape[0], hkv, group,
                                      *mask.shape[2:]))
        logits = torch.where(mask, logits, logits.new_tensor(NEG_F32))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float())
    return out.reshape(b, tq, hq, d).to(q.dtype)
