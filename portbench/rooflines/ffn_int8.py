"""`ffn_int8` (csrc/gated_mlp.cuh, FFN variant): y = (act(x W1 s1 + b1))
W2 s2 + b2 with int8 W1 [d, f] and W2 [f, d], f32 scales and biases, bf16
x and y.  In a window it runs in the int8 S3 llm stack's decode, one call
a block a step."""

import re

from portbench.rooflines import bound_s

PATTERN = re.compile(r"gated_(mlp|gemv)_kernel<false, true")
OPS_PER_CALL = {"ffn_int8": 1}
# the S3 prefill takes the kernel up to this many rows (batch x prefix;
# the program's FUSED_MLP_MAX_ROWS, ops/quantized.py)
PREFILL_ROWS_MAX = 256


def work(rows: int, d: int, hidden: int):
    weights = 2 * d * hidden + 4 * 2 * (hidden + d)
    return 4.0 * rows * d * hidden, float(weights + 2 * 2 * rows * d)


def window(shapes):
    """The S3 decode's calls: each `shapes["s3_decode"]` record ({"rows",
    "prefix", "steps"}) is one decode of `rows` rows, a prefill of
    `prefix` positions, then `steps` steps of one position a row."""
    calls = shapes.get("s3_decode")
    if not calls:
        return None
    llm = shapes["cfg"].speech_decoder.llm
    d, hidden, blocks = llm.output_size, llm.linear_units, llm.num_blocks
    n, bound = 0, 0.0
    for c in calls:
        n += c["steps"] * blocks
        bound += c["steps"] * blocks * bound_s(*work(c["rows"], d, hidden))
        prefill = c["rows"] * c["prefix"]
        if prefill <= PREFILL_ROWS_MAX:
            n += blocks
            bound += blocks * bound_s(*work(prefill, d, hidden))
    return {"calls": {"ffn_int8": n}, "bound_s": bound}
