"""Weight-only int8 / int4 modules and the fused-MLP / int4 dispatch
(counterpart of the JAX ops/quantized.py).

Quantized kernels are [in, out] int8 buffers beside float32 per-output-
channel scales, or nibble-packed [in/2, out] uint8 buffers beside float32
group-wise scales [in/g, out] (kernels/int4_matmul.py), and float32 biases,
in the layout quant.py and convert.py produce.  The scales and biases stay
float32 when the model is cast to bf16, as the JAX parameters do.  Products
run in the dtype of their input, as JAX's `dtype` argument has them.

Dispatch rules as in JAX: an int4 product of at most INT4_KERNEL_MAX_ROWS
rows takes kernels/int4_matmul.py, a larger one one dequantization and a
plain product; a fused MLP of at most FUSED_MLP_MAX_ROWS rows is one kernel
call (kernels/fused_mlp.py), a larger one the unfused math on the same
weights; the int4 tied head always takes the int4 kernel.  Each kernel's
plain version runs instead where a module's `use_kernels` is False.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from taste_spokenlm_tpu_torch.kernels import fused_mlp, int4_matmul

FUSED_MLP_MAX_ROWS = 256
INT4_KERNEL_MAX_ROWS = 256


def qmode(flag):
    """A quantized_serving flag -> None | "int8" | "int4"."""
    if not flag:
        return None
    if flag is True:
        return "int8"
    if flag not in ("int8", "int4"):
        raise ValueError(f"quantized_serving {flag!r}")
    return flag


def _rows(x: torch.Tensor) -> int:
    return x.numel() // x.shape[-1]


class F32Buffers(nn.Module):
    """Keeps every floating buffer of the module float32 through `.to()`,
    `.half()` and the like (the quantized layouts' scales and biases)."""

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        for name, buf in self._buffers.items():
            if buf is not None and buf.is_floating_point() \
                    and buf.dtype != torch.float32:
                self._buffers[name] = buf.float()
        return self


class QDense(F32Buffers):
    """int8 Dense: kernel_q int8 [in, out], scale f32 [out], bias f32 [out]
    (use_bias).  y = (x @ q) * scale + bias in x's dtype."""

    def __init__(self, in_dim: int, features: int, use_bias: bool = True):
        super().__init__()
        self.register_buffer("kernel_q", torch.zeros(in_dim, features,
                                                     dtype=torch.int8))
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features) if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        y = (x @ self.kernel_q.to(dt)) * self.scale.to(dt)
        return y if self.bias is None else y + self.bias.to(dt)


def int4_param_shapes(in_dim: int, features: int):
    """(packed kernel shape, scale shape) of the int4 serving layout."""
    n_scales = in_dim // int4_matmul._group(in_dim)
    return (in_dim // 2, features), (n_scales, features)


class QDense4(F32Buffers):
    """int4 Dense: kernel_q4 uint8 [in/2, out] (nibble-packed), scale f32
    [in/g, out] (group-wise), bias f32 [out] (use_bias).  y = x @
    dequant(kernel_q4, scale) + bias through int4_apply, in x's dtype."""

    def __init__(self, in_dim: int, features: int, use_bias: bool = True):
        super().__init__()
        wp_shape, s_shape = int4_param_shapes(in_dim, features)
        self.use_kernels = True
        self.register_buffer("kernel_q4", torch.zeros(wp_shape,
                                                      dtype=torch.uint8))
        self.register_buffer("scale", torch.ones(s_shape))
        self.register_buffer("bias", torch.zeros(features) if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int4_apply(x, self.kernel_q4, self.scale, x.dtype, self.use_kernels)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def dense(in_dim: int, features: int, quantized=False, use_bias: bool = True
          ) -> nn.Module:
    """nn.Linear, QDense or QDense4 by the serving flag."""
    mode = qmode(quantized)
    if mode == "int4":
        return QDense4(in_dim, features, use_bias)
    if mode == "int8":
        return QDense(in_dim, features, use_bias)
    return nn.Linear(in_dim, features, bias=use_bias)


def int4_apply(x: torch.Tensor, wp: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype, use_kernel: bool = True) -> torch.Tensor:
    """x [..., D] @ dequant(wp, scale): the kernel (its plain version when
    not `use_kernel`) up to 256 rows, above it one dequantization and a
    plain product."""
    if _rows(x) <= INT4_KERNEL_MAX_ROWS:
        fn = (int4_matmul.matmul_int4 if use_kernel
              else int4_matmul.matmul_int4_plain)
        return fn(x, wp, scale).to(dtype)
    return x.to(dtype) @ int4_matmul.dequantize_int4(wp, scale).to(dtype)


def fused_gated_mlp_apply(x, gate, up, down, mode: str, dtype,
                          activation: str = "silu", use_kernel: bool = True):
    """The Llama MLP over (weights, scale) pairs in `mode` "int8" ([in, out]
    int8) or "int4" (packed, down per tile): one kernel call for
    decode-sized inputs (its plain version when not `use_kernel`), the
    unfused math above FUSED_MLP_MAX_ROWS."""
    if _rows(x) <= FUSED_MLP_MAX_ROWS:
        fn = {("int8", True): fused_mlp.gated_mlp_int8,
              ("int8", False): fused_mlp.gated_mlp_int8_plain,
              ("int4", True): fused_mlp.gated_mlp_int4,
              ("int4", False): fused_mlp.gated_mlp_int4_plain}[mode, use_kernel]
        return fn(x, gate[0], gate[1], up[0], up[1], down[0], down[1],
                  activation).to(dtype)
    act = fused_mlp.act_fn(activation)
    if mode == "int4":
        g = int4_apply(x, gate[0], gate[1], dtype)
        u = int4_apply(x, up[0], up[1], dtype)
        wd = fused_mlp.dequantize_int4_tiled(
            down[0], down[1], fused_mlp.mlp_tile(gate[0].shape[1])).to(dtype)
        return (act(g) * u).to(dtype) @ wd
    x = x.to(dtype)
    g = (x @ gate[0].to(dtype)) * gate[1].to(dtype)
    u = (x @ up[0].to(dtype)) * up[1].to(dtype)
    return ((act(g) * u) @ down[0].to(dtype)) * down[1].to(dtype)


def fused_ffn_apply(x, w1, w2, mode: str, dtype, activation: str = "swish",
                    use_kernel: bool = True):
    """The conformer FFN over (weights, scale, bias) triples in `mode` "int8"
    or "int4" (w2 packed per tile): one kernel call for decode-sized inputs
    (its plain version when not `use_kernel`), the unfused math above
    FUSED_MLP_MAX_ROWS."""
    if _rows(x) <= FUSED_MLP_MAX_ROWS:
        fn = {("int8", True): fused_mlp.ffn_int8,
              ("int8", False): fused_mlp.ffn_int8_plain,
              ("int4", True): fused_mlp.ffn_int4,
              ("int4", False): fused_mlp.ffn_int4_plain}[mode, use_kernel]
        return fn(x, *w1, *w2, activation).to(dtype)
    act = fused_mlp.act_fn(activation)
    if mode == "int4":
        h = int4_apply(x, w1[0], w1[1], dtype) + w1[2].to(dtype)
        w = fused_mlp.dequantize_int4_tiled(
            w2[0], w2[1], fused_mlp.mlp_tile(w1[0].shape[1])).to(dtype)
        return act(h).to(dtype) @ w + w2[2].to(dtype)
    x = x.to(dtype)
    h = (x @ w1[0].to(dtype)) * w1[1].to(dtype) + w1[2].to(dtype)
    return (act(h) @ w2[0].to(dtype)) * w2[1].to(dtype) + w2[2].to(dtype)


class QEmbed(F32Buffers):
    """int8 embedding table with per-row scales; a tied head reads it as
    (h @ q^T) * scale, or with head_mode "int4" the transposed nibble-packed
    copy through the int4 kernel (its plain version when `use_kernels` is
    False)."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32, head_mode: str = "int8",
                 int4_group: int = 128):
        super().__init__()
        self.dtype, self.head_mode = dtype, head_mode
        self.use_kernels = True
        self.register_buffer("embedding_q", torch.zeros(
            num_embeddings, features, dtype=torch.int8))
        self.register_buffer("embedding_scale", torch.ones(num_embeddings))
        if head_mode == "int4":
            g = int4_matmul._group(features, int4_group)
            self.register_buffer("head_q4", torch.zeros(
                features // 2, num_embeddings, dtype=torch.uint8))
            self.register_buffer("head_scale4", torch.ones(
                features // g, num_embeddings))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        rows = self.embedding_q[ids].to(self.dtype)
        return rows * self.embedding_scale[ids][..., None].to(self.dtype)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """-> f32 logits [..., V]."""
        if self.head_mode == "int4":
            fn = (int4_matmul.matmul_int4 if self.use_kernels
                  else int4_matmul.matmul_int4_plain)
            return fn(hidden, self.head_q4, self.head_scale4)
        h = hidden.to(torch.bfloat16).float()
        return (h @ self.embedding_q.float().T) * self.embedding_scale
