"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each module holds a plain version (same signature, same numerics, JAX
layout), a wrapper that runs the plain version for a CPU tensor and the
CUDA kernel for a CUDA tensor (never a fallback between the two), and a
launch counter on the wrapper (`wrapper.launches`), one per kernel call:
`flash_attention.launches`, `fused_dit_block.launches`,
`conv1d_same.launches`, `gated_mlp_int8.launches`, `ffn_int8.launches`,
`gated_mlp_int4.launches`, `ffn_int4.launches`, `matmul_int4.launches`,
`relpos_causal_attention.launches` (the rel-pos forward),
`relpos_causal_attention_bwd.launches` (its backward, one per backward
call of the autograd function), `logits_int8.launches` and
`matmul_int8.launches`.  `launch_counts()` maps each wrapper's
name to its count.
"""

from taste_spokenlm_tpu_torch.kernels import (conv1d, flash_attention,
                                              fused_dit, fused_mlp,
                                              int4_matmul, int8_matmul,
                                              relpos_attention)

KERNEL_SOURCES = ("flash_attention", "fused_dit", "conv1d", "fused_mlp",
                  "fused_mlp_int4", "int4_matmul", "relpos_attention",
                  "int8_matmul")
_WRAPPERS = (flash_attention.flash_attention, fused_dit.fused_dit_block,
             conv1d.conv1d_same, fused_mlp.gated_mlp_int8, fused_mlp.ffn_int8,
             fused_mlp.gated_mlp_int4, fused_mlp.ffn_int4,
             int4_matmul.matmul_int4,
             relpos_attention.relpos_causal_attention,
             relpos_attention.relpos_causal_attention_bwd,
             int8_matmul.logits_int8, int8_matmul.matmul_int8)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}
