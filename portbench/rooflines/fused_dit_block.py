"""`fused_dit_block` (csrc/fused_dit.cu, five launches a call): the flow's
transformer block, LayerNorm -> qkv -> attention over the valid keys ->
out projection + residual -> LayerNorm -> GELU MLP (x4) + residual, bf16,
over `rows` sequences of `t` frames (the CFG halves counted as rows).
In a window it runs in the flow's U-Net estimator, every CFM step."""

import re

from portbench.rooflines import bound_s

PATTERN = re.compile(r"(gemm|attn)_kernel.*(GemmArgs|AttnArgs)")
OPS_PER_CALL = {"fused_dit_block": 5}


def work(t: int, valid, c: int, heads: int, head_dim: int):
    """`valid` holds each row's count of valid keys."""
    inner = heads * head_dim
    m = len(valid) * t
    attn = sum(4.0 * heads * t * v * head_dim for v in valid)
    flops = (2.0 * m * c * 3 * inner + attn + 2.0 * m * inner * c
             + 2.0 * 2 * m * c * 4 * c)
    weights = 3 * c * inner + inner * c + inner + 8 * c * c + 5 * c + 4 * c
    return flops, 2.0 * (2 * m * c + weights)


def levels(ts_valid, estimator_channels, n_blocks, n_mid, n_timesteps):
    """{level: calls} of one flow inference: the U-Net's down path, its
    middle and its up path, each U-Net block `n_blocks` transformer
    blocks, every CFM step."""
    n_ch = len(estimator_channels)
    calls = {}

    def add(level, n):
        calls[level] = calls.get(level, 0) + n
    for i in range(n_ch):
        add(i, n_blocks)
    add(n_ch - 1, n_mid * n_blocks)
    for i in range(n_ch):
        add(n_ch - 1 - i, n_blocks)
    return {k: v * n_timesteps for k, v in calls.items()}


def window(shapes):
    """The flow's calls: each `shapes["flow"]` record ({"mel_len",
    "frames"}) is one inference over rows padded to `mel_len` frames with
    `frames` valid each, both CFG halves run as rows."""
    calls = shapes.get("flow")
    if not calls:
        return None
    f = shapes["cfg"].flow
    n_levels = len(f.estimator_channels)
    n, bound = 0, 0.0
    for c in calls:
        ts, valid = [c["mel_len"]], [list(c["frames"]) * 2]
        for _ in range(n_levels - 1):
            ts.append((ts[-1] + 1) // 2)
            valid.append([(v + 1) // 2 for v in valid[-1]])
        for level, k in levels(ts, f.estimator_channels, f.estimator_n_blocks,
                               f.estimator_num_mid_blocks,
                               f.n_timesteps).items():
            n += k
            bound += k * bound_s(*work(
                ts[level], valid[level],
                f.estimator_channels[min(level, n_levels - 1)],
                f.estimator_num_heads, f.estimator_attention_head_dim))
    return {"calls": {"fused_dit_block": n}, "bound_s": bound}
