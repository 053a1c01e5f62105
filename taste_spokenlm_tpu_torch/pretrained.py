"""One-line checkpoint loading (counterpart of the JAX pretrained.py).

A checkpoint directory of the port holds

    <dir>/config.json   TasteConfig.to_json
    <dir>/model.pt      the model's state dict (torch.save)

`save_pretrained` writes one, from any layout (float, or a quantized
serving layout: the config says which, as the JAX package's converted
directories do); `from_pretrained` builds the model the config describes
at the dtypes its weights were saved in and loads the state dict into it
with strict=True, and returns it with a TasteProcessor.  Pair them with `TasteForCausalLM.inference_reconstruction`,
`frontend.api.CompletionPipeline` or `serving.server.TasteEngine`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple, Union

import torch

from taste_spokenlm_tpu_torch.config import TasteConfig
from taste_spokenlm_tpu_torch.device import resolve_device

CONFIG_FILE = "config.json"
WEIGHTS_FILE = "model.pt"


def load_config(checkpoint_dir: str) -> TasteConfig:
    with open(os.path.join(checkpoint_dir, CONFIG_FILE)) as f:
        return TasteConfig.from_dict(json.load(f))


def save_pretrained(model, checkpoint_dir: str) -> None:
    """Write `model`'s config and state dict into `checkpoint_dir`."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    with open(os.path.join(checkpoint_dir, CONFIG_FILE), "w") as f:
        f.write(model.config.to_json())
    torch.save(model.state_dict(), os.path.join(checkpoint_dir, WEIGHTS_FILE))


# A float weight of each part whose dtype is the one the model was built
# at, in every layout: the LM's final norm (TasteForCausalLM's `dtype`, of
# everything but the audio tower) and the whisper encoder's first conv (its
# `tower_dtype`).
LM_DTYPE_KEY = "spoken_lm.language_model.norm.weight"
TOWER_DTYPE_KEY = ("audio_tower.audio_joint_encoder_segmenter.audio_encoder."
                   "encoder.conv1.weight")


def saved_dtypes(state: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.dtype, torch.dtype]:
    """-> (dtype, tower_dtype) that the saved model was built at."""
    return state[LM_DTYPE_KEY].dtype, state[TOWER_DTYPE_KEY].dtype


def from_pretrained(
    checkpoint_dir: str,
    *,
    dtype: Optional[torch.dtype] = None,
    config_overrides: Optional[Dict] = None,
    llm_tokenizer: Any = None,
    asr_tokenizer: Any = None,
    speaker_embedder: Any = None,
    s3_tokenizer: Any = None,
    transcriber: Any = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[Any, Any]:
    """Load a checkpoint dir -> (model in eval mode, processor), both on
    `device` (None: CUDA, which must be present).  The model takes the
    dtypes its weights were saved in (the LM's and the audio tower's);
    `dtype` overrides them, building the model as TasteForCausalLM(config,
    dtype) does and casting the weights to it.  `config_overrides`
    replaces top-level config fields before the model is built.  The
    tokenizers and hooks are the caller's; the processor handles the
    signal processing without them."""
    from taste_spokenlm_tpu_torch.frontend.processor import TasteProcessor
    from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM

    cfg = load_config(checkpoint_dir)
    if config_overrides:
        cfg = cfg.replace(**config_overrides)
    dev = resolve_device(device)
    state = torch.load(os.path.join(checkpoint_dir, WEIGHTS_FILE),
                       map_location=dev, weights_only=True)
    lm_dtype, tower_dtype = saved_dtypes(state)
    if dtype is not None:
        lm_dtype = tower_dtype = dtype
    with torch.device(dev):       # built in place: no host copy first
        model = TasteForCausalLM(cfg, dtype=lm_dtype, tower_dtype=tower_dtype,
                                 device=dev)
    model.load_state_dict(state, strict=True)
    processor = TasteProcessor(
        asr_tokenizer=asr_tokenizer, llm_tokenizer=llm_tokenizer,
        speaker_embedder=speaker_embedder, s3_tokenizer=s3_tokenizer,
        transcriber=transcriber, frontend=cfg.frontend, device=model.device)
    return model.eval(), processor
