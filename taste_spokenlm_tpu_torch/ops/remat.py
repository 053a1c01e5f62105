"""Per-layer gradient checkpointing (counterpart of the JAX ops/remat.py).

The `remat` config fields take False | True | "dots" | "dots_no_batch".
True recomputes each checkpointed layer in the backward
(`torch.utils.checkpoint.checkpoint(use_reentrant=False)`), as JAX's
`nn.remat` does; the policies that keep the matmul outputs ("dots",
"dots_no_batch") are not ported yet and raise.  Only layers are wrapped,
never the RVQ: a recomputed forward would apply its EMA update twice.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint


def apply_remat(cfg, rm):
    """Set the remat policy on every stack gradients flow through in the
    stage-1 / stage-2 steps (whisper tower, the speech decoder's encoders
    and LM, the spoken LM's Llama) of a port TasteConfig."""
    return cfg.replace(
        audio_tower=cfg.audio_tower.replace(
            whisper=cfg.audio_tower.whisper.replace(remat=rm)),
        speech_decoder=cfg.speech_decoder.replace(
            text_encoder=cfg.speech_decoder.text_encoder.replace(remat=rm),
            audio_encoder=cfg.speech_decoder.audio_encoder.replace(remat=rm),
            llm=cfg.speech_decoder.llm.replace(remat=rm)),
        spoken_lm=cfg.spoken_lm.replace(
            llama=cfg.spoken_lm.llama.replace(remat=rm)))


def call_layer(layer, remat: Any, *args, **kwargs):
    """layer(*args, **kwargs), checkpointed when `remat` is on and autograd
    records; keyword arguments must be static (bools, None)."""
    if remat in (False, None) or not torch.is_grad_enabled():
        return layer(*args, **kwargs)
    if remat is not True:
        raise NotImplementedError(
            f"remat policy {remat!r}: only full recompute (True) is ported; "
            "the 'dots' policies are in ROADMAP.md queue A, "
            '"The training harness"')
    return checkpoint(lambda *a: layer(*a, **kwargs), *args,
                      use_reentrant=False)
