"""Fused CFM U-Net transformer block (LN -> masked MHA -> +res -> LN ->
4C GELU MLP -> +res).

Replaces the TPU kernel ops/pallas/fused_dit.py:110 `fused_dit_block`
(`_kernel`) with csrc/fused_dit.cu.  The TPU kernel keeps a whole [Tp, Tp]
f32 score tensor per head in VMEM, which does not fit a Hopper SM's shared
memory, so the CUDA version is a chain of five launches per block: LN1 +
q/k/v product, masked two-pass-softmax attention, out-projection + bias +
residual, LN3 + MLP-in + GELU, MLP-out + bias + residual.  Every product
runs on the tensor cores (mma.sync, bf16 operands, f32 sums): the GEMMs
over a cp.async ring of weight tiles, the LN statistics taken from the
staged rows; the attention with its query fragments and P in registers,
two passes over the keys (row max and sum, then the normalised P . V).

It keeps the TPU kernel's numerics, which differ from the unfused block:
flax fast variance E[x^2] - mu^2 clamped at 0, the Abramowitz-Stegun erf in
the GELU, and bf16 casts after LN, after each projection, after the
normalised softmax and after each residual branch.  `launches` counts one
per block (five CUDA launches); the output repeats bit for bit.

Bound on the H100: at the flow's shapes (B=2, T=904 or 452, C=256, 8 heads
x 64, MLP 1024) the block does far more operations than bytes it moves, a
few microseconds of tensor-core work; the chain of small launches is
bound by latency.
"""

from __future__ import annotations

import torch

from taste_spokenlm_tpu_torch.kernels import _build

NEG_INF = -1e30
_SIGNATURE = {"tsk_fused_dit_block": (
    _build.P, _build.P, *([_build.I] * 5), *([_build.P] * 16))}


def layer_norm_fast_var(x, scale, bias, eps: float = 1e-5):
    """flax nn.LayerNorm numerics: f32 stats, var = E[x^2] - mu^2 >= 0."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    h = (x32 - mu) * torch.rsqrt(var + eps)
    return h * scale.float() + bias.float()


def norm_cdf_as(x):
    """0.5 * (1 + erf(x / sqrt(2))) with the Abramowitz-Stegun 7.1.26 erf."""
    z = x * (2.0 ** -0.5)
    a = torch.abs(z)
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    erf_abs = 1.0 - poly * torch.exp(-a * a)
    return 0.5 * (1.0 + torch.sign(z) * erf_abs)


def fused_dit_block_plain(x, lengths, params, *, heads: int, head_dim: int):
    """The kernel's arithmetic in PyTorch.  x [B, T, C]; lengths [B] valid
    key counts; params the block's flax-layout subtree (kernels [in, out])."""
    b, t, c = x.shape
    dt = x.dtype
    at = params["attn1"]

    def mm(a, w):
        return a.float() @ w.float()

    h = layer_norm_fast_var(x, params["norm1"]["scale"],
                            params["norm1"]["bias"]).to(dt)
    q = mm(h, at["to_q"]["kernel"]).to(dt).view(b, t, heads, head_dim)
    k = mm(h, at["to_k"]["kernel"]).to(dt).view(b, t, heads, head_dim)
    v = mm(h, at["to_v"]["kernel"]).to(dt).view(b, t, heads, head_dim)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * head_dim ** -0.5
    key_ok = torch.arange(t, device=x.device)[None, :] < lengths.to(x.device)[:, None]
    s = torch.where(key_ok[:, None, None, :], s, s.new_tensor(NEG_INF))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)).to(dt)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(dt)
    a = (mm(o.reshape(b, t, heads * head_dim), at["to_out"]["kernel"])
         + at["to_out"]["bias"].float()).to(dt)
    x = x + a
    h = layer_norm_fast_var(x, params["norm3"]["scale"],
                            params["norm3"]["bias"]).to(dt)
    f = mm(h, params["ff_in"]["kernel"]) + params["ff_in"]["bias"].float()
    f = (f * norm_cdf_as(f)).to(dt)
    f = (mm(f, params["ff_out"]["kernel"])
         + params["ff_out"]["bias"].float()).to(dt)
    return x + f


def _param_list(params):
    at = params["attn1"]
    return [params["norm1"]["scale"], params["norm1"]["bias"],
            at["to_q"]["kernel"], at["to_k"]["kernel"], at["to_v"]["kernel"],
            at["to_out"]["kernel"], at["to_out"]["bias"],
            params["norm3"]["scale"], params["norm3"]["bias"],
            params["ff_in"]["kernel"], params["ff_in"]["bias"],
            params["ff_out"]["kernel"], params["ff_out"]["bias"]]


def fused_dit_block(x, lengths, params, *, heads: int, head_dim: int):
    """One BasicTransformerBlock.  CPU tensors take the plain version; CUDA
    tensors launch csrc/fused_dit.cu (bf16 only)."""
    if x.device.type == "cpu":
        return fused_dit_block_plain(x, lengths, params, heads=heads,
                                     head_dim=head_dim)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dit_block: unsupported device {x.device}")
    b, t, c = x.shape
    inner = heads * head_dim
    plist = _param_list(params)
    if x.dtype != torch.bfloat16 or any(p.dtype != torch.bfloat16 for p in plist):
        raise TypeError("fused_dit_block: the CUDA kernel takes bfloat16 "
                        "activations and weights")
    if head_dim != 64 or c % 64 or inner % 128:
        raise ValueError(f"fused_dit_block: needs head_dim 64, C % 64 == 0 and "
                         f"inner % 128 == 0 (got {head_dim}, {c}, {inner})")
    shapes = [(c,), (c,), (c, inner), (c, inner), (c, inner), (inner, c),
              (c,), (c,), (c,), (c, 4 * c), (4 * c,), (4 * c, c), (c,)]
    for p, shape in zip(plist, shapes):
        if tuple(p.shape) != shape or not p.is_contiguous() \
                or p.device != x.device or p.data_ptr() % 16:
            raise ValueError(f"fused_dit_block: parameter of shape "
                             f"{tuple(p.shape)} on {p.device}, expected a "
                             f"contiguous, 16-byte aligned {shape} on "
                             f"{x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_dit_block: x must be contiguous and 16-byte "
                         "aligned")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"fused_dit_block: lengths shape {tuple(lengths.shape)}")
    lens = lengths.to(device=x.device, dtype=torch.int32).contiguous()
    lib = _build.load("fused_dit", _SIGNATURE)
    # qkv, attention output, x1 and the MLP's hidden rows: one allocation
    scratch = torch.empty(b * t * (4 * inner + 5 * c), dtype=x.dtype,
                          device=x.device)
    out = torch.empty_like(x)
    err = lib.tsk_fused_dit_block(
        _build.ptr(x), _build.ptr(lens), b, t, c, heads, head_dim,
        *[_build.ptr(p) for p in plist], _build.ptr(scratch), _build.ptr(out),
        _build.stream_of(x))
    _build.check(err, "fused_dit_block")
    fused_dit_block.launches += 1
    return out


fused_dit_block.launches = 0


def can_use_fused_dit(t: int, c: int, inner: int) -> bool:
    """The JAX eligibility gate (ops/pallas/fused_dit.py:164)."""
    return t <= 1024 and c % 128 == 0 and inner % 128 == 0
