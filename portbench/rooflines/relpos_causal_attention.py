"""`relpos_causal_attention` forward and backward (csrc/relpos_attention.cu;
the bf16 route): ESPnet rel-pos attention, strict causal, over the valid
causal pairs of each row.  Forward: q_u, q_v, k, v, p and the lengths read,
o and the LSE written, three products of 2 d operations a pair.  Backward
(five launches a call): the forward's inputs, o, dO and the LSE read, five
gradients written, eight products a pair (the two score products again,
dO.v, dv, dk, dq_u, dq_v, dp).  In a window it runs in the S3 llm stack's
teacher-forced pass of a training step: one forward a block (two under
remat, which runs it again for the backward) and one backward."""

import re

from portbench.rooflines import bound_s

PATTERN = re.compile(r"(?<![A-Za-z_])(fwd_kernel|delta_kernel|dq_kernel|"
                     r"dkv_kernel|dp_kernel|dp_sum_kernel|dp_reduce_kernel)")
OPS_PER_CALL = {"relpos_causal_attention": 1,
                "relpos_causal_attention_bwd": 5}


def pairs(lengths):
    return sum(n * (n + 1) // 2 for n in lengths)


def forward(b: int, t: int, heads: int, dk: int, lengths, width: int = 2):
    n_el, p_el = b * t * heads * dk, (2 * t - 1) * heads * dk
    in_bytes = width * (4 * n_el + p_el) + 4 * b
    return (6.0 * dk * heads * pairs(lengths),
            float(in_bytes + width * n_el + 4 * b * heads * t))


def backward(b: int, t: int, heads: int, dk: int, lengths, width: int = 2):
    n_el, p_el = b * t * heads * dk, (2 * t - 1) * heads * dk
    in_bytes = width * (4 * n_el + p_el) + 4 * b
    return (16.0 * dk * heads * pairs(lengths),
            float(in_bytes + 2 * width * n_el + 4 * b * heads * t
                  + width * (4 * n_el + p_el)))


def window(shapes):
    """The S3 stack's training passes: each `shapes["s3_train"]` record
    ({"rows", "width", "lengths", "bytes"}) is one step over `rows` rows
    padded to `width` positions, `lengths` valid each."""
    steps = shapes.get("s3_train")
    if not steps:
        return None
    llm = shapes["cfg"].speech_decoder.llm
    heads, blocks = llm.attention_heads, llm.num_blocks
    dk = llm.output_size // heads
    n_fwd = 2 if llm.remat else 1
    bound = 0.0
    for s in steps:
        args = (s["rows"], s["width"], heads, dk, s["lengths"], s["bytes"])
        bound += blocks * (n_fwd * bound_s(*forward(*args))
                           + bound_s(*backward(*args)))
    return {"calls": {"relpos_causal_attention": n_fwd * blocks * len(steps),
                      "relpos_causal_attention_bwd": blocks * len(steps)},
            "bound_s": bound}
