"""VoiceGenerator: S3 speech tokens -> 22.05 kHz waveform, flow + HiFT
(counterpart of the JAX models/generator.py)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from taste_spokenlm_tpu_torch.config import FlowConfig, HiFTConfig
from taste_spokenlm_tpu_torch.models.flow import MaskedDiffWithXvec
from taste_spokenlm_tpu_torch.models.hift import HiFTGenerator
from taste_spokenlm_tpu_torch.utils import profiling


class VoiceGenerator(nn.Module):
    """`dtype` is the serving compute dtype of the flow's encoder and
    estimator and of the HiFT convs."""

    def __init__(self, flow_config: FlowConfig, hift_config: HiFTConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.flow = MaskedDiffWithXvec(flow_config, dtype=dtype)
        self.hift = HiFTGenerator(hift_config, dtype=dtype)

    @torch.no_grad()
    def forward(self, speech_token_ids: torch.Tensor,
                speech_token_lengths: torch.Tensor,
                flow_embedding: torch.Tensor, mel_len_max: int,
                n_timesteps: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                z: Optional[torch.Tensor] = None,
                source_phase: Optional[torch.Tensor] = None,
                source_noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (waveform [B, mel_len_max*256], sample lengths [B]).

        The random draws come from `generator` unless given: the CFM start
        noise `z` [B, mel_len_max, n_mels] (standard normal) and the sine
        source's initial phases `source_phase` [B, H+1, 1] (uniform in
        [-pi, pi)) and `source_noise` [B, H+1, samples] (standard normal)."""
        with profiling.span("flow"):
            mel, mel_lengths = self.flow.inference(
                speech_token_ids, speech_token_lengths, flow_embedding,
                mel_len_max, n_timesteps, z=z, generator=generator)
        with profiling.span("hift"):
            wav = self.hift(mel, source_phase, source_noise, generator)
        samples_per_frame = wav.shape[1] // mel.shape[1]
        return wav, mel_lengths * samples_per_frame
