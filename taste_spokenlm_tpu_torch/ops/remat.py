"""Per-layer gradient checkpointing (counterpart of the JAX ops/remat.py).

The `remat` config fields take False | True | "dots" | "dots_no_batch".
Each checkpoints the layer (`torch.utils.checkpoint.checkpoint`,
use_reentrant=False), as JAX's `nn.remat` does; the policy shapes what the
backward recomputes, never the math:

* True recomputes the whole layer;
* "dots" keeps the outputs of the matrix products (aten mm, addmm, bmm,
  baddbmm and convolution) and recomputes the rest, JAX's
  `checkpoint_dots`;
* "dots_no_batch" keeps only the products with no batch dimension (mm,
  addmm: the weight contractions), JAX's
  `checkpoint_dots_with_no_batch_dims`.

The policies select by aten op (`create_selective_checkpoint_contexts`),
so the port's flash and rel-pos kernels, which are not aten ops, are
recomputed under either, as a Pallas call is not a dot to JAX's policy.
Only layers are wrapped, never the RVQ: a recomputed forward would apply
its EMA update twice.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

VALID_REMAT = (False, True, "dots", "dots_no_batch")

_aten = torch.ops.aten
_SAVED = {
    "dots": [_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default, _aten.convolution.default],
    "dots_no_batch": [_aten.mm.default, _aten.addmm.default],
}


def parse_remat(value: str) -> Any:
    """A CLI / env remat string -> a config field value; raises ValueError
    on an unknown name."""
    rm = {"1": True, "true": True, "full": True, "on": True,
          "0": False, "false": False, "off": False}.get(value.lower(), value)
    if rm not in VALID_REMAT:
        raise ValueError(f"unknown remat policy {value!r} "
                         "(off | full | dots | dots_no_batch)")
    return rm


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
    """layer(*args, **kwargs), checkpointed under the policy `remat` when it
    is on and autograd records; keyword arguments must be static (bools,
    None)."""
    if remat in (False, None) or not torch.is_grad_enabled():
        return layer(*args, **kwargs)
    if remat is True:
        return checkpoint(lambda *a: layer(*a, **kwargs), *args,
                          use_reentrant=False)
    if remat not in _SAVED:
        raise ValueError(f"unknown remat policy {remat!r} "
                         "(False | True | 'dots' | 'dots_no_batch')")
    return checkpoint(lambda *a: layer(*a, **kwargs), *args,
                      use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts,
                          _SAVED[remat]))
