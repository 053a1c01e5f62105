"""An offline resynthesis job: `TasteForCausalLM.inference_reconstruction`
("SpeechAutoEncoder") over batches of utterances, closed loop, one call
after the other.  The S3 decode's Gumbel draws, the flow's start noise and
HiFT's source draws are made by the harness from the seed and passed in.

A few rows of each call are decoded greedily (their Gumbel draws zero),
as greedy requests mixed into the job.  `correct` holds a sample of the
finished utterances (the greedy one with the most served S3 tokens, a
second greedy one, and others drawn from the seed) to the float32
reference: the tower's taste (the RVQ's input and the indices it chose), the S3 stack along each
greedy row's served trajectory (the gap by which a served token's logit
lies below the reference's best), the flow's mel for the served tokens
and start noise, and HiFT's waveform for the program's mel and source
draws.
"""

from __future__ import annotations

import math
import random
import time
from typing import Dict, List

import torch

from portbench import common, generator, inputs, program


class Cell:
    def __init__(self, cell: Dict, seed: int, device, traced: bool,
                 tiny: bool = False, seconds: float = 30.0):
        self.cell, self.seed, self.tiny = cell, int(seed), tiny
        self.dev = torch.device(device)
        self.traffic = generator.load_traffic(cell["traffic"])
        if tiny:
            self.traffic.update(self.traffic["tiny"])
        self.spans = common.Spans(traced, sync=self.dev.type == "cuda")
        self.calls: List[Dict] = []

    # -- set-up -----------------------------------------------------------

    def setup(self) -> None:
        t = self.traffic
        self.model, self.cfg, self.meta = program.build(
            self.cell["config_file"], self.seed, self.dev, self.tiny)
        h = self.cfg.hift
        self.spf = math.prod(h.upsample_rates) * h.istft_hop_len
        gen = torch.Generator(device=self.dev).manual_seed(self.seed)
        self.pool = [self._make_call(d, gen) for d in generator.batches(
            t, t["pool_calls"], self.seed)]
        self._mels: List[torch.Tensor] = []
        flow = self.model.voice_generator.flow
        inner = flow.inference

        def keep_mel(*args, **kwargs):
            mel, lengths = inner(*args, **kwargs)
            self._mels.append(mel)
            return mel, lengths
        flow.inference = keep_mel
        self._zs: List[torch.Tensor] = []
        self.model.audio_tower.vq.rvq.project_in.register_forward_hook(
            lambda m, args, out: self._zs.append(out))
        self.spans.wrap(self.model.audio_tower, "forward", "audio_tower")
        self.spans.wrap(self.model.speech_decoder, "generate", "s3_generate")
        self.spans.wrap(flow, "inference", "flow")
        self.spans.wrap(self.model.voice_generator.hift, "forward", "hift")
        self._run(0)
        self._mels.clear()
        self._zs.clear()
        self._sync()

    def _make_call(self, durations, gen) -> Dict:
        t, cfg = self.traffic, self.cfg
        wav = inputs.speech_like(
            durations, inputs.window_samples(cfg.audio_tower.whisper), gen,
            self.dev)
        mel = inputs.whisper_log_mel(wav, cfg.audio_tower.whisper.n_mels)
        counts = [generator.token_count(d, t["asr_tokens_per_s"],
                                        t["asr_tokens_max"])
                  for d in durations]
        ids, lengths, words = inputs.token_rows(
            counts, max(counts), cfg.audio_tower.whisper.vocab_size, gen,
            self.dev)
        spk = torch.randn((len(durations), cfg.speech_decoder.spk_embed_dim),
                          generator=gen, device=self.dev)
        return {"mel": mel, "ids": ids, "lengths": lengths, "words": words,
                "spk": spk, "audio_s": float(sum(durations))}

    def greedy_rows(self, i: int) -> List[int]:
        """Call i's rows decoded greedily (no Gumbel noise): the rows that
        the S3 check reads, since a sampled token under top-k has no
        margin that rounding at the top-k boundary cannot flip."""
        return sorted(random.Random(f"{self.seed}:greedy{i}").sample(
            range(self.traffic["batch"]), self.traffic["greedy_rows"]))

    def _draws(self, i: int) -> Dict[str, torch.Tensor]:
        """Call i's draws, made alike for the program and the reference."""
        t, cfg = self.traffic, self.cfg
        b, steps, mel_len = t["batch"], t["s3_steps"], t["mel_len_max"]
        g = torch.Generator(device=self.dev).manual_seed(
            (self.seed * 1_000_003 + i) % (2 ** 63))
        u = torch.rand((steps, b, cfg.speech_decoder.speech_token_size + 1),
                       generator=g, device=self.dev)
        u = torch.clamp(u, min=torch.finfo(torch.float32).tiny,
                        max=1.0 - 2 ** -24)
        gumbel = -torch.log(-torch.log(u))
        gumbel[:, self.greedy_rows(i)] = 0.0
        h = cfg.hift.nb_harmonics + 1
        up = mel_len * self.spf
        return {"gumbel": gumbel,
                "z": torch.randn((b, mel_len, cfg.flow.output_size),
                                 generator=g, device=self.dev),
                "source_phase": (torch.rand((b, h, 1), generator=g,
                                            device=self.dev) * 2 - 1)
                * torch.pi,
                "source_noise": torch.randn((b, h, up), generator=g,
                                            device=self.dev)}

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def _run(self, i: int) -> Dict:
        t = self.traffic
        call = self.pool[i % len(self.pool)]
        return self.model.inference_reconstruction(
            call["spk"], call["ids"], call["lengths"], call["words"],
            call["mel"], max_speech_steps=t["s3_steps"],
            mel_len_max=t["mel_len_max"], sampling_k=t["sampling_k"],
            **self._draws(i))

    # -- the window -------------------------------------------------------

    def window(self, seconds: float) -> Dict:
        from taste_spokenlm_tpu_torch import kernels
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        i, ends = 0, [t0]
        while True:
            out = self._run(i)
            self._sync()
            end = time.perf_counter()
            ends.append(end)
            out["mel"] = self._mels.pop()
            out["z"] = self._zs.pop()
            self.calls.append(out)
            i += 1
            if end - t0 >= seconds:
                break
        self.launches = kernels.launch_counts()
        self.window_s = end - t0
        audio = sum(self.pool[c % len(self.pool)]["audio_s"]
                    for c in range(len(self.calls)))
        return {"attempted": len(self.calls) * self.traffic["batch"],
                "failed": 0,
                "metrics": {"recon_audio_s_per_s": audio / self.window_s},
                "call_s": [b - a for a, b in zip(ends, ends[1:])]}

    def release(self) -> None:
        del self.model
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- per-layer context ------------------------------------------------

    def _steps(self, out) -> int:
        return min(self.traffic["s3_steps"],
                   int(out["speech_token_lengths"].max()) + 1)

    def shapes(self) -> Dict:
        """The window's work by part of the model (portbench/rooflines/):
        each call's tower forward, S3 decode and flow inference."""
        t = self.traffic
        tower_bytes, _ = program.element_bytes(self.cell["config_file"])
        out = {"cfg": self.cfg, "encoder": [], "s3_decode": [], "flow": []}
        for c, res in enumerate(self.calls):
            call = self.pool[c % len(self.pool)]
            out["encoder"].append({"rows": t["batch"], "bytes": tower_bytes})
            out["s3_decode"].append({
                "rows": t["batch"], "prefix": 3 + int(call["lengths"].max()),
                "steps": self._steps(res)})
            out["flow"].append({
                "mel_len": t["mel_len_max"],
                "frames": (res["waveform_lengths"] // self.spf).tolist()})
        return out

    def layer_context(self) -> Dict:
        from portbench.flops import ModelFlops
        counter = ModelFlops(program.taste_configs(
            self.cell["config_file"], self.tiny)[1].to_dict())
        model_flops = 0.0
        for c, out in enumerate(self.calls):
            call = self.pool[c % len(self.pool)]
            frames = (out["waveform_lengths"] // self.spf).tolist()
            for r in range(self.traffic["batch"]):
                n_tok = int(call["lengths"][r])
                n_s3 = int(out["speech_token_lengths"][r])
                model_flops += (counter.tower_call(n_tok)
                                + counter.s3_row(n_tok, n_s3)
                                + counter.flow_row(frames[r])
                                + counter.hift_row(frames[r]))
        return {"spans": self.spans.seconds,
                "s3_steps": sum(self._steps(out) for out in self.calls),
                "launches": self.launches, "model_flops": model_flops,
                "shapes": self.shapes()}

    # -- correct ----------------------------------------------------------

    def sample(self) -> List[tuple]:
        """(call, row) pairs: the greedy row with the most served S3 tokens
        and another greedy row, then rows drawn from the seed."""
        rng = random.Random(f"{self.seed}:sample")
        rows = [(c, r) for c in range(len(self.calls))
                for r in range(self.traffic["batch"])]
        greedy = [(c, r) for c, r in rows if r in self.greedy_rows(c)]
        longest = max(greedy, key=lambda cr: int(
            self.calls[cr[0]]["speech_token_lengths"][cr[1]]))
        others = [cr for cr in greedy if cr != longest]
        picked = [longest] + rng.sample(others, min(1, len(others)))
        rest = [cr for cr in rows if cr not in picked]
        rng.shuffle(rest)
        return picked + rest[:self.cell["workload"]["sample_rows"]
                             - len(picked)]

    def verify(self) -> Dict[str, Dict]:
        """The compared numbers beside their limits."""
        from portbench.reference import pipeline
        limits = self.cell["workload"]["limits"]
        float_cfg = program.taste_configs(self.cell["config_file"],
                                          self.tiny)[1]
        ref_cfg = pipeline.reference_config(float_cfg.to_dict())
        sd = inputs.seeded_state_dict(
            self.meta, self.seed, self.dev,
            prefixes=("audio_tower.", "speech_decoder.", "voice_generator."))
        ref = pipeline.build(ref_cfg, sd, device=self.dev)
        del sd
        t = self.traffic
        eos = ref_cfg.speech_decoder.speech_token_size
        worst = {"tower_err": 0.0, "s3_logit_gap": 0.0,
                 "flow_mel_err": 0.0, "hift_wav_err": 0.0}
        with pipeline.matmul_precision(False):
            for c, r in self.sample():
                call, out = self.pool[c % len(self.pool)], self.calls[c]
                dr = {k: v[:, r:r + 1] if k == "gumbel" else v[r:r + 1]
                      for k, v in self._draws(c).items()}
                sl = slice(r, r + 1)
                indices = out["quantized_indices"][sl]
                tokens = out["speech_token_ids"][sl].clamp(min=0)
                n = int(out["speech_token_lengths"][r])
                mel = out["mel"][sl]
                frames = int(out["waveform_lengths"][r]) // self.spf
                worst["tower_err"] = max(
                    worst["tower_err"], pipeline.tower_err(
                        ref["tower"], call["mel"][sl], call["ids"][sl],
                        call["lengths"][sl], call["words"][sl], indices,
                        out["z"][sl]))
                embeds = pipeline.audio_unit_embeds(ref["tower"], indices)
                logits = pipeline.s3_logits(
                    ref["s3"], call["spk"][sl], embeds, call["ids"][sl],
                    call["lengths"][sl], tokens, n)
                min_len = int((3 + int(call["lengths"][r])) * 2.0)
                if r in self.greedy_rows(c):
                    worst["s3_logit_gap"] = max(
                        worst["s3_logit_gap"], pipeline.s3_gap(
                            logits, tokens[0, :n], dr["gumbel"][:n, 0],
                            min_len, eos, t["sampling_k"]))
                worst["flow_mel_err"] = max(
                    worst["flow_mel_err"], pipeline.flow_err(
                        ref["voice"], tokens, n, call["spk"][sl],
                        t["mel_len_max"], dr["z"], mel))
                worst["hift_wav_err"] = max(
                    worst["hift_wav_err"], pipeline.hift_err(
                        ref["voice"], mel, frames, dr["source_phase"],
                        dr["source_noise"], out["waveform"][sl]))
        return {k: {"value": v, "limit": limits[k]} for k, v in worst.items()}
