"""Flash attention: softmax(q k^T * scale) v on [B, T, H, D].

Replaces the TPU kernel ops/pallas/flash_attention.py:120 `flash_attention`
(`_block_attn_kernel` / `_flash_kernel`) with csrc/flash_attention.cu: one
CTA per (batch*head, query tile), 64-key K/V tiles streamed through shared
memory with the next tile's copy in flight, online softmax, f32 sums.  Two
kernels, chosen by dtype:
  * bf16 on the tensor cores (mma.sync, 16 query rows a warp, P kept in
    registers as the bf16 operand of P.V), the frozen encoder of the
    stage-1 step;
  * f32 in true f32 FMAs on the SIMT units, never TF32 or tensor cores: the
    served whisper tower runs f32 and its RVQ argmin over 512 codes flips
    on TF32-scale drift.  4 x 8 register blocks of S over operands stored
    transposed in shared memory, read as float4s along rows and keys.

The TPU kernel traces under DEFAULT matmul precision (the JAX package's
ops/pallas/_precision.py); the port is held against the JAX f32 XLA path and
against `flash_attention_plain` below, not against the TPU's arithmetic.

Bound on the H100: the 4*T^2*D*H*B operations, not the 4 * B*T*H*D
elements it must move: on the tensor cores in bf16 (989 TFLOP/s; 93 us at
B=8, T=1500, H=20, D=64), on the SIMT f32 units in f32 (67 TFLOP/s; 172 us
at B=1).
"""

from __future__ import annotations

from typing import Optional

import torch

from taste_spokenlm_tpu_torch.kernels import _build

NEG_INF = -1e30
_SIGNATURE = {"tsk_flash_attention": (
    _build.P, _build.P, _build.P, _build.P, _build.I, _build.I, _build.I,
    _build.I, _build.I, _build.I, _build.F32, _build.I, _build.P, _build.P)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False,
                          scale: Optional[float] = None,
                          kv_lengths: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: f32 scores, keys at or past
    kv_lengths[b] (default Tk) and (if causal) col > row masked to -1e30, P
    cast to the value dtype before the value product, output
    acc / max(l, 1e-30)."""
    tq, tk, d = q.shape[1], k.shape[1], q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_lengths is not None:
        ok = (torch.arange(tk, device=q.device)[None, :]
              < kv_lengths.to(q.device)[:, None])
        s = torch.where(ok[:, None, None, :], s, s.new_tensor(NEG_INF))
    if causal:
        ok = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril()
        s = torch.where(ok, s, s.new_tensor(NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    o = o / torch.clamp(l, min=1e-30)
    return o.transpose(1, 2).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None,
                    kv_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, Tq, H, D], k/v [B, Tk, H, D] -> [B, Tq, H, D].  `kv_lengths`
    [B] are the true key lengths when k/v are padded past them (the Pallas
    kernel's valid_len).  CPU tensors take the plain version; CUDA tensors
    launch csrc/flash_attention.cu.  Neither takes inputs that require
    grad: the kernel has no backward, nor has the Pallas kernel it
    replaces."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError("flash_attention has no backward: call it on "
                           "inputs that do not require grad (a frozen "
                           "encoder under torch.no_grad())")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale, kv_lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; needs all float32 or all bfloat16")
    if q.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, tq, h, d = q.shape
    if d not in (32, 64, 128):
        raise ValueError(f"flash_attention: head dim {d} not in 32/64/128")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: inputs must be contiguous")
    lens = None
    if kv_lengths is not None:
        if tuple(kv_lengths.shape) != (b,):
            raise ValueError(f"flash_attention: kv_lengths shape "
                             f"{tuple(kv_lengths.shape)}, expected ({b},)")
        lens = kv_lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if scale is None:
        scale = d ** -0.5
    lib = _build.load("flash_attention", _SIGNATURE)
    out = torch.empty_like(q)
    err = lib.tsk_flash_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        _DTYPES[q.dtype], b, tq, k.shape[1], h, d, float(scale), int(causal),
        None if lens is None else _build.ptr(lens), _build.stream_of(q))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def can_use_flash(tq: int, tk: int, min_len: int = 256) -> bool:
    """The JAX gate: worth the kernel only for long sequences."""
    return tq >= min_len and tk >= min_len
