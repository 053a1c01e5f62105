"""Causal espnet rel-pos attention, forward and backward, for the conformer
training path:

    s[i, j] = (q_u[i] . k[j] + q_v[i] . p[(T-1) - i + j]) / sqrt(dk)
    o = softmax(s masked to j <= i and j < len_b) @ v

Replaces the TPU kernel ops/pallas/relpos_attention.py:291
`relpos_causal_attention` (forward `_fwd_kernel` :114, backward
`_bwd_kernel` :155, the `jax.custom_vjp` at :307) with
csrc/relpos_attention.cu.  The TPU kernel forms the bd term as one
q_v @ p_window matmul plus a log2(BQ) masked-shift skew, because a TPU
cannot gather; the CUDA kernels index the table directly, and under the
causal mask only rows 0..T-1 of p are ever read, so dp's rows T..2T-2 are
exactly zero.  The forward is an online softmax over the key tiles j <= i
that saves the LSE; the backward recomputes the scores against it, with the
TPU kernel's cast points (prob and g rounded to the operand dtype before the
dv, dk, dq_u, dq_v and dp products), in five launches and no float atomics,
so its gradients repeat bit for bit.

Bound on the H100: at the stage-1 S3 stack's shape (B=8, T=1599, H=8,
dk=128, bf16) the ~3 T^2 dk B H forward and ~8 T^2 dk B H backward
operations over the causal half, not the bytes.  The float32 route runs
them on the SIMT f32 units (true f32 FMAs, never TF32).  The bfloat16 route
runs them on the tensor cores (mma.sync, bf16 operands, f32 sums).  Its
forward is one launch: per query tile (the longest first) the scores of
every key tile j <= i (the bd term as q_v times a 128-row table window,
skewed by one offset read from shared memory), an online softmax in
registers, and o += bf16(e) . v, the key tiles through a two-stage cp.async
ring.  Its backward: delta = rowsum(dO . o); per query tile the same scores
(one device function for both), prob and g of each key tile, dq_u and dq_v, and
prob and g stored per tile pair in bf16; per key tile dk and dv from the
stored tiles; per tile diagonal, whose pairs share one table window, dp's
window partial from the stored g; then dp summed over the batch and the
overlapping windows in a fixed order.

The wrappers run the plain versions below for CPU tensors and the CUDA
kernels for CUDA tensors, never one for the other; each kernel launch adds
one to its wrapper's `launches` (`relpos_causal_attention.launches` for the
forward, `relpos_causal_attention_bwd.launches` for the backward).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from taste_spokenlm_tpu_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIM = 128
MIN_LEN = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = _build.P, _build.I
_SIGNATURES = {
    "tsk_relpos_fwd": (_P,) * 8 + (_I,) * 4 + (_P,),
    "tsk_relpos_bwd": (_P,) * 17 + (_I,) * 4 + (_P,),
    "tsk_relpos_bwd_scratch": (_I,) * 4 + (_P,),
}


def can_use_relpos_flash(t: int, dk: int, min_len: int = MIN_LEN) -> bool:
    """The JAX gate: long sequences and a head dim of 128."""
    return t >= min_len and dk == HEAD_DIM


def _lengths(lengths: Optional[torch.Tensor], b: int, t: int, dev
             ) -> torch.Tensor:
    if lengths is None:
        return torch.full((b,), t, dtype=torch.int32, device=dev)
    return torch.clamp(lengths.to(device=dev, dtype=torch.int32), 0, t)


def _scores(q_u, q_v, k, p, lengths):
    """f32 scores [B, H, T, T] and the mask (j <= i and j < len_b)."""
    b, t, h, dk = q_u.shape
    dev = q_u.device
    ac = torch.einsum("bqhd,bkhd->bhqk", q_u.float(), k.float())
    i = torch.arange(t, device=dev)
    idx = (t - 1) - i[:, None] + i[None, :]               # [T, T]
    # only rows 0..T-1 of the table are read where j <= i
    bd = torch.einsum("bqhd,phd->bhqp", q_v.float(), p[:t].float())
    bd = torch.gather(bd, 3, torch.clamp(idx, 0, t - 1)[None, None]
                      .expand(b, h, t, t))
    s = (ac + bd) * (1.0 / math.sqrt(dk))
    lens = _lengths(lengths, b, t, dev)
    mask = ((i[None, :] <= i[:, None])[None, None]
            & (i[None, None, None, :] < lens[:, None, None, None]))
    return torch.where(mask, s, s.new_tensor(NEG_INF)), mask


def relpos_causal_attention_plain(q_u, q_v, k, v, p, lengths=None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's arithmetic in PyTorch: -> (o [B, T, H, dk] in the q
    dtype, lse f32 [B*H, T]).  Masked entries hold -1e30 and contribute 0;
    the unnormalised probabilities are rounded to the value dtype before the
    value product; o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))."""
    b, t, h, dk = q_u.shape
    s, mask = _scores(q_u, q_v, k, p, lengths)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(s - m), s.new_zeros(()))
    l = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    acc = torch.einsum("bhqk,bkhd->bhqd", e.to(v.dtype).float(), v.float())
    o = (acc / l).transpose(1, 2).to(q_u.dtype)
    lse = (m + torch.log(l))[..., 0].reshape(b * h, t)
    return o, lse


def relpos_causal_attention_bwd_plain(q_u, q_v, k, v, p, lengths, o, lse, do):
    """The backward's arithmetic in PyTorch, recomputed from the LSE:
    -> (dq_u, dq_v, dk, dv [B, T, H, dk]; dp [2T-1, H, dk] summed over the
    batch, rows T..2T-2 zero).  prob = exp(s - lse); delta = rowsum(dO . o)
    in f32; g = prob (dO . v^T - delta) / sqrt(dk); prob and g are rounded to
    the operand dtype before the products, as the TPU kernel does."""
    b, t, h, dk = q_u.shape
    dt = q_u.dtype
    s, mask = _scores(q_u, q_v, k, p, lengths)
    lse = lse.reshape(b, h, t, 1)
    prob = torch.where(mask, torch.exp(s - lse), s.new_zeros(()))
    do = do.to(dt)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None]
    dpv = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    g = prob * (dpv - delta) * (1.0 / math.sqrt(dk))
    prob_lp, g_lp = prob.to(dt).float(), g.to(dt).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", prob_lp, do.float())
    dk_ = torch.einsum("bhqk,bqhd->bkhd", g_lp, q_u.float())
    dq_u = torch.einsum("bhqk,bkhd->bqhd", g_lp, k.float())
    # g[i, j] lands on table row (T-1) - i + j: scatter it onto the rows
    i = torch.arange(t, device=q_u.device)
    idx = torch.clamp((t - 1) - i[:, None] + i[None, :], 0, t - 1)
    gw = torch.zeros((b, h, t, t), dtype=torch.float32, device=q_u.device)
    gw = gw.scatter_add(3, idx[None, None].expand(b, h, t, t),
                        torch.where(mask, g_lp, g_lp.new_zeros(())))
    dq_v = torch.einsum("bhqr,rhd->bqhd", gw, p[:t].float())
    dp = torch.zeros((2 * t - 1, h, dk), dtype=torch.float32,
                     device=q_u.device)
    dp[:t] = torch.einsum("bhqr,bqhd->rhd", gw, q_v.float())
    return (dq_u.to(dt), dq_v.to(dt), dk_.to(k.dtype), dv.to(v.dtype),
            dp.to(p.dtype))


def _check(q_u, q_v, k, v, p, lengths) -> None:
    if q_u.device.type != "cuda":
        raise ValueError(f"relpos_causal_attention: unsupported device "
                         f"{q_u.device}")
    xs = (q_u, q_v, k, v, p)
    if q_u.dtype not in _DTYPES or any(x.dtype != q_u.dtype for x in xs):
        raise TypeError("relpos_causal_attention: dtypes "
                        f"{[str(x.dtype) for x in xs]}; needs all float32 "
                        "or all bfloat16")
    if q_u.dim() != 4 or any(x.shape != q_u.shape for x in (q_v, k, v)):
        raise ValueError("relpos_causal_attention: shapes "
                         f"{[tuple(x.shape) for x in xs]}")
    b, t, h, dk = q_u.shape
    if tuple(p.shape) != (2 * t - 1, h, dk):
        raise ValueError(f"relpos_causal_attention: p shape {tuple(p.shape)},"
                         f" expected {(2 * t - 1, h, dk)}")
    if not can_use_relpos_flash(t, dk):
        raise ValueError(f"relpos_causal_attention: T={t}, dk={dk}; the "
                         f"kernel takes T >= {MIN_LEN} and dk == {HEAD_DIM}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("relpos_causal_attention: inputs must be contiguous")
    if any(x.data_ptr() % 16 for x in xs):
        raise ValueError("relpos_causal_attention: inputs must be 16-byte "
                         "aligned")
    if any(x.device != q_u.device for x in xs):
        raise ValueError("relpos_causal_attention: inputs on several devices")
    if lengths is not None and tuple(lengths.shape) != (b,):
        raise ValueError(f"relpos_causal_attention: lengths shape "
                         f"{tuple(lengths.shape)}, expected ({b},)")


def _bwd_scratch(lib, dtype, b: int, t: int, h: int, dev):
    """The backward's scratch, carved from one allocation: delta f32, pg
    bf16 (None for float32) and dp_part f32, sized by the library
    (tsk_relpos_bwd_scratch), which defines their layouts."""
    sizes = (ctypes.c_longlong * 3)()
    _build.check(lib.tsk_relpos_bwd_scratch(_DTYPES[dtype], b, t, h,
                                            ctypes.addressof(sizes)),
                 "relpos_causal_attention_bwd scratch")
    offs = [0]
    for n in sizes:
        offs.append(offs[-1] + -(-n // 256) * 256)
    buf = torch.empty(offs[-1], dtype=torch.uint8, device=dev)
    views = [buf[o:o + n] for o, n in zip(offs, sizes)]
    return (views[0].view(torch.float32),
            views[1].view(torch.bfloat16) if sizes[1] else None,
            views[2].view(torch.float32))


def relpos_causal_attention_fwd(q_u, q_v, k, v, p, lengths):
    """(o, lse [B*H, T] f32) with lengths [B] int32: the plain version for
    CPU tensors, the kernel for CUDA tensors (its launch counted on
    `relpos_causal_attention.launches`)."""
    if q_u.device.type == "cpu":
        return relpos_causal_attention_plain(q_u, q_v, k, v, p, lengths)
    _check(q_u, q_v, k, v, p, lengths)
    b, t, h, dk = q_u.shape
    lens = _lengths(lengths, b, t, q_u.device).contiguous()
    lib = _build.load("relpos_attention", _SIGNATURES)
    o = torch.empty_like(q_u)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q_u.device)
    ptr = _build.ptr
    err = lib.tsk_relpos_fwd(ptr(q_u), ptr(q_v), ptr(k), ptr(v), ptr(p),
                             ptr(lens), ptr(o), ptr(lse), _DTYPES[q_u.dtype],
                             b, t, h, _build.stream_of(q_u))
    _build.check(err, "relpos_causal_attention")
    relpos_causal_attention.launches += 1
    return o, lse


def relpos_causal_attention_bwd(q_u, q_v, k, v, p, lengths, o, lse, do):
    """(dq_u, dq_v, dk, dv, dp) from the forward's inputs, output and LSE
    and the output's gradient: the plain version for CPU tensors, the
    kernels for CUDA tensors (five launches, counted as one backward)."""
    if q_u.device.type == "cpu":
        return relpos_causal_attention_bwd_plain(q_u, q_v, k, v, p, lengths,
                                                 o, lse, do)
    _check(q_u, q_v, k, v, p, lengths)
    b, t, h, dk = q_u.shape
    do = do.to(q_u.dtype).contiguous()
    if o.shape != q_u.shape or do.shape != q_u.shape \
            or tuple(lse.shape) != (b * h, t) or do.data_ptr() % 16:
        raise ValueError("relpos_causal_attention_bwd: o / do / lse shapes "
                         f"{tuple(o.shape)} / {tuple(do.shape)} / "
                         f"{tuple(lse.shape)}, or do not 16-byte aligned")
    lens = _lengths(lengths, b, t, q_u.device).contiguous()
    lib = _build.load("relpos_attention", _SIGNATURES)
    dq_u, dq_v, dk_, dv = (torch.empty_like(q_u) for _ in range(4))
    dp = torch.empty_like(p)
    delta, pg, dp_part = _bwd_scratch(lib, q_u.dtype, b, t, h, q_u.device)
    ptr = _build.ptr
    err = lib.tsk_relpos_bwd(
        ptr(q_u), ptr(q_v), ptr(k), ptr(v), ptr(p), ptr(lens), ptr(o.contiguous()),
        ptr(lse.contiguous()), ptr(do), ptr(dq_u), ptr(dq_v), ptr(dk_), ptr(dv),
        ptr(dp), ptr(delta), None if pg is None else ptr(pg), ptr(dp_part),
        _DTYPES[q_u.dtype], b, t, h, _build.stream_of(q_u))
    _build.check(err, "relpos_causal_attention_bwd")
    relpos_causal_attention_bwd.launches += 1
    return dq_u, dq_v, dk_, dv, dp


class _RelposAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_u, q_v, k, v, p, lengths):
        o, lse = relpos_causal_attention_fwd(q_u, q_v, k, v, p, lengths)
        ctx.save_for_backward(q_u, q_v, k, v, p, lengths, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q_u, q_v, k, v, p, lengths, o, lse = ctx.saved_tensors
        grads = relpos_causal_attention_bwd(q_u, q_v, k, v, p, lengths, o,
                                            lse, do)
        return (*grads, None)


def relpos_causal_attention(q_u: torch.Tensor, q_v: torch.Tensor,
                            k: torch.Tensor, v: torch.Tensor, p: torch.Tensor,
                            lengths: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """q_u, q_v (query + pos_bias_u / pos_bias_v), k, v [B, T, H, dk]; p
    [2T-1, H, dk] the projected rel-pos table, row c encoding offset
    c - (T-1); lengths [B] valid key counts (None: all T).  -> o
    [B, T, H, dk] in the q dtype, strictly causal, differentiable in all
    five tensors.  CUDA tensors launch the kernels and must meet the
    kernel's terms (float32 or bfloat16 throughout, dk == 128, T >= 256,
    contiguous); CPU tensors run the plain versions."""
    lens = _lengths(lengths, q_u.shape[0], q_u.shape[1], q_u.device)
    return _RelposAttention.apply(q_u, q_v, k, v, p, lens)


relpos_causal_attention.launches = 0
relpos_causal_attention_bwd.launches = 0
