"""The port's entry point for a harness that runs one forward
(counterpart of the JAX repo's __graft_entry__.entry).

entry() -> (fn, example_args): the stage-1 speech-autoencoder forward of
the composite model (whisper tower + RVQ + speech decoder, the training
hot path) at TasteConfig.tiny(), on the device asked for (default CUDA;
"cpu" for the plain versions).  `fn(model, *batch)` -> (loss,
speech_token_accuracy); example_args = (model, *batch), the model with
create_seed_model's seeded weights and JAX's tiny batch (RandomState(0),
two rows).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

BATCH_KEYS = ("speaker_embeds", "asr_token_ids", "asr_token_lengths",
              "asr_word_ids", "audio_features", "speech_token_ids",
              "speech_token_lengths")


def tiny_batch(cfg, b: int = 2) -> dict:
    """JAX's _tiny_batch, drawn in its order from RandomState(0) (numpy)."""
    rng = np.random.RandomState(0)
    t_tok, t_sp = 8, 12
    w = cfg.audio_tower.whisper
    return {
        "speaker_embeds": rng.randn(b, cfg.speech_decoder.spk_embed_dim
                                    ).astype(np.float32),
        "asr_token_ids": rng.randint(5, w.vocab_size, (b, t_tok)),
        "asr_token_lengths": np.asarray([t_tok] * b),
        "asr_word_ids": np.minimum(np.arange(t_tok) // 2,
                                   t_tok - 1)[None].repeat(b, 0),
        "audio_features": rng.randn(b, w.n_mels, 2 * w.max_source_positions
                                    ).astype(np.float32),
        "speech_token_ids": rng.randint(
            0, cfg.speech_decoder.speech_token_size, (b, t_sp)),
        "speech_token_lengths": np.asarray([t_sp] * b),
    }


def forward(model, speaker_embeds, asr_token_ids, asr_token_lengths,
            asr_word_ids, audio_features, speech_token_ids,
            speech_token_lengths):
    out = model.forward_speech_autoencoder(
        speaker_embeds, asr_token_ids, asr_token_lengths, asr_word_ids,
        audio_features, speech_token_ids, speech_token_lengths)
    return out["loss"], out["speech_token_accuracy"]


def entry(device: Optional[Union[str, torch.device]] = None, seed: int = 0):
    """(fn, example_args): the stage-1 forward on the tiny composite."""
    from taste_spokenlm_tpu_torch.config import TasteConfig
    from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM
    from taste_spokenlm_tpu_torch.scripts._cli import to_device
    from taste_spokenlm_tpu_torch.scripts.create_seed_model import (
        seed_state_dict)
    cfg = TasteConfig.tiny()
    model = TasteForCausalLM(cfg, device=device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    model.load_state_dict(seed_state_dict(model, gen), strict=True)
    batch = to_device(tiny_batch(cfg), model.device)
    return forward, (model.eval(), *(batch[k] for k in BATCH_KEYS))
