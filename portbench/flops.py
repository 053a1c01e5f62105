"""Model FLOPs of the work a window did, counted from shapes: torch's
FlopCounterMode over the plain reference modules run on fake tensors (no
arithmetic is done).  Each component's count is a polynomial of degree two
in the length it grows with (attention is quadratic in it, every other
product linear), fitted through three exact counts, so a window of many
rows of different lengths is counted without counting each row.

The counts are those of the plain path: full attention squares for the
causal S3 stack, as the plain path computes them, the flow at each row's
own mel length (the useful frames, not the padding).  A training step's
trainable part counts three times its forward (forward and backward)."""

from __future__ import annotations

import functools
from typing import Callable, Dict

import numpy as np
import torch


class ModelFlops:
    def __init__(self, float_model: Dict):
        from portbench.reference.audio_tower import TasteAudioTower
        from portbench.reference.generator import VoiceGenerator
        from portbench.reference.pipeline import reference_config
        from portbench.reference.speech_decoder import TasteSpeechDecoder
        self.cfg = reference_config(float_model)
        with torch.device("meta"):
            self.tower = TasteAudioTower(self.cfg.audio_tower)
            self.s3 = TasteSpeechDecoder(self.cfg.speech_decoder)
            self.voice = VoiceGenerator(self.cfg.flow, self.cfg.hift)
        for m in (self.tower, self.s3, self.voice):
            m.to_empty(device="cpu")
        self._fits: Dict[str, np.ndarray] = {}

    def _count(self, fn: Callable[[], object]) -> float:
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils.flop_counter import FlopCounterMode
        with FakeTensorMode(allow_non_fake_inputs=True), \
                FlopCounterMode(display=False) as fc, torch.no_grad():
            fn()
        return float(fc.get_total_flops())

    def _poly(self, key: str, make: Callable[[int], Callable], xs) -> Callable:
        if key not in self._fits:
            ys = [self._count(make(x)) for x in xs]
            self._fits[key] = np.polyfit(np.asarray(xs, float), ys, 2)
        return functools.partial(np.polyval, self._fits[key])

    # components, one row each --------------------------------------------

    def encoder(self) -> float:
        """The whisper encoder over one 30 s window."""
        if "encoder" not in self._fits:
            w = self.cfg.audio_tower.whisper
            self._fits["encoder"] = self._count(lambda: self.tower._encode(
                torch.zeros(1, w.n_mels, 3000)))
        return self._fits["encoder"]

    def segmenter(self, n_tok: int) -> float:
        """The aggregator (the whisper decoder over the encoder's states)
        and the RVQ for `n_tok` asr tokens."""
        tw = self.tower
        d = tw.config.whisper.d_model
        n_prompt = len(tw.config.whisper.decoder_prompt)

        def make(t):
            def run():
                n = n_prompt + t + 1
                src = torch.zeros(1, 1500, d)
                out, _ = tw.decoder(torch.zeros(1, n, dtype=torch.long), src,
                                    src, input_lengths=torch.full((1,), n))
                tw.vq.rvq(out[:, n_prompt:-1],
                          mask=torch.ones(1, t, dtype=torch.bool))
            return run
        return float(self._poly("segmenter", make, (8, 32, 96))(n_tok))

    def tower_call(self, n_tok: int) -> float:
        return self.encoder() + self.segmenter(n_tok)

    def s3_condition(self, n_tok: int) -> float:
        """The S3 text and audio encoders and the fusion over n_tok."""
        def make(t):
            return lambda: self.s3.prepare_conditional_embeds(
                torch.zeros(1, self.cfg.speech_decoder.spk_embed_dim),
                torch.zeros(1, t, self.cfg.speech_decoder
                            .audio_encoder_input_size),
                torch.full((1,), t), torch.zeros(1, t, dtype=torch.long),
                torch.full((1,), t))
        return float(self._poly("s3_condition", make, (8, 32, 96))(n_tok))

    def s3_llm(self, length: int) -> float:
        """The S3 llm stack and its head over `length` positions."""
        c = self.cfg.speech_decoder

        def make(t):
            return lambda: self.s3.llm_decoder(self.s3.llm(
                torch.zeros(1, t, c.llm_input_size), torch.full((1,), t)))
        return float(self._poly("s3_llm", make, (64, 512, 1600))(length))

    def s3_row(self, n_tok: int, n_s3: int) -> float:
        return self.s3_condition(n_tok) + self.s3_llm(3 + n_tok + n_s3)

    def flow_row(self, mel_frames: int) -> float:
        """The flow over the row's own mel frames: its encoder once and
        each CFM step (two counts, at one step and at two, tell them
        apart)."""
        f = self.cfg.flow

        def make(steps):
            def at(t):
                n_tok = max(1, int(t * 50 * 256 / 22050))
                return lambda: self.voice.flow.inference(
                    torch.zeros(1, n_tok, dtype=torch.long),
                    torch.full((1,), n_tok), torch.zeros(1, f.spk_embed_dim),
                    t, n_timesteps=steps, z=torch.zeros(1, t, f.output_size))
            return at
        one = self._poly("flow1", make(1), (96, 400, 904))(mel_frames)
        two = self._poly("flow2", make(2), (96, 400, 904))(mel_frames)
        return float(one + (two - one) * (f.n_timesteps - 1))

    def hift_row(self, mel_frames: int) -> float:
        h = self.cfg.hift
        up = int(np.prod(h.upsample_rates)) * h.istft_hop_len

        def make(t):
            return lambda: self.voice.hift(
                torch.zeros(1, t, h.in_channels),
                torch.zeros(1, h.nb_harmonics + 1, 1),
                torch.zeros(1, h.nb_harmonics + 1, t * up))
        return float(self._poly("hift", make, (96, 400, 904))(mel_frames))
