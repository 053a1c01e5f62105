"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each module holds a plain version (same signature, same numerics, JAX
layout), a wrapper that runs the plain version for a CPU tensor and the
CUDA kernel for a CUDA tensor (never a fallback between the two), and a
launch counter on the wrapper (`wrapper.launches`).
"""

from taste_spokenlm_tpu_torch.kernels import (conv1d, flash_attention,
                                              fused_dit, fused_mlp,
                                              int4_matmul)

KERNEL_SOURCES = ("flash_attention", "fused_dit", "conv1d", "fused_mlp",
                  "int4_matmul")
_WRAPPERS = (flash_attention.flash_attention, fused_dit.fused_dit_block,
             conv1d.conv1d_same, fused_mlp.gated_mlp_int8, fused_mlp.ffn_int8,
             int4_matmul.matmul_int4)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}
