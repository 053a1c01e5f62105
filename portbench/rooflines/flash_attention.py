"""`flash_attention` (csrc/flash_attention.cu), non-causal: q, k, v read
and o written once; QK^T and PV, 2 * T * T * d operations each a head.
In a window it runs in the whisper encoder, one call a layer."""

import re

from portbench.rooflines import bound_s

PATTERN = re.compile(r"flash_kernel_(bf16|f32)")
OPS_PER_CALL = {"flash_attention": 1}


def work(b: int, t: int, heads: int, head_dim: int, width: int):
    """(operations, bytes) of one call over [b, t, heads, head_dim] in
    elements of `width` bytes."""
    return (4.0 * b * heads * t * t * head_dim,
            4.0 * b * t * heads * head_dim * width)


def window(shapes):
    """The whisper encoder's calls: each `shapes["encoder"]` record
    ({"rows", "bytes"}) is one forward over `rows` 30-s windows."""
    calls = shapes.get("encoder")
    if not calls:
        return None
    w = shapes["cfg"].audio_tower.whisper
    t, hd = w.max_source_positions, w.d_model // w.encoder_heads
    return {"calls": {"flash_attention": len(calls) * w.encoder_layers},
            "bound_s": sum(w.encoder_layers * bound_s(*work(
                c["rows"], t, w.encoder_heads, hd, c["bytes"]))
                for c in calls)}
