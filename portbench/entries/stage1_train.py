"""Stage-1 training (`train/train_step.py` `make_stage1_step`): batches of
rows, each a whisper window with a stretch of speech in it, its asr tokens
and its S3 targets, padded to the traffic's fixed widths.  Batches are made
from the seed in set-up, kept on the host, and copied to the card in each
step; the RVQ's draws (the quantize-dropout level, the dead-code picks)
are made by the harness and passed as `draws`.

Set-up builds one step (model and optimizer state) and drives it through
its first steps on batches whose rows all differ, through the window's own
call and feed; the window then goes on with the same object.  `correct`
holds those first steps to the plain float32 reference
(portbench/reference/train_ref.py) on the same weights, batches and draws:
the first gradient as the optimizer got it (from its first moment after
one step) and the parameters' change after the first steps, both leaf by
leaf; each step's loss is printed beside them."""

from __future__ import annotations

import random
import sys
import time
from typing import Dict

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

    # -- set-up -----------------------------------------------------------

    def setup(self) -> None:
        from taste_spokenlm_tpu_torch.train import optim, train_step
        layout = self.cell["config_file"]["layout"]
        t = self.traffic
        self.model, self.cfg, self.meta = program.build(
            self.cell["config_file"], self.seed, self.dev, self.tiny)
        mask = optim.trainable_mask(self.model,
                                    optim.STAGE1_PHASES[layout["phase"]])
        self.names = [n for n, _ in self.model.named_parameters() if mask[n]]
        self.opt = optim.make_optimizer(
            self.model, layout["learning_rate"], mask=mask,
            grad_clip=layout["grad_clip"])
        self.step = train_step.make_stage1_step(self.model, self.opt,
                                                trainable_mask=mask)
        self.spans.wrap(self, "step", "train_step")
        gen = torch.Generator(device=self.dev).manual_seed(self.seed)
        durations = generator.batches(t, t["pool_batches"], self.seed)
        self.pool = [self._make_batch(d, gen) for d in durations]
        self.batch_audio_s = float(sum(durations[0]))
        self.first_losses = []
        for i in range(t["first_steps"]):
            metrics = self._run(i)
            self.first_losses.append((float(metrics["loss"]),
                                      float(metrics["commit_loss"])))
            if i == 0:
                self.first_mu = [m.detach().to("cpu", torch.float32,
                                                copy=True)
                                 for m in self.opt.mu]
        self.after_first = {n: p.detach().to("cpu", torch.float32,
                                             copy=True)
                            for n, p in self.model.named_parameters()
                            if n in set(self.names)}

    def _make_batch(self, durations, gen) -> Dict[str, torch.Tensor]:
        t, cfg = self.traffic, self.cfg
        b = len(durations)
        wav = inputs.speech_like(
            durations, inputs.window_samples(cfg.audio_tower.whisper), gen,
            self.dev)
        mel = inputs.whisper_log_mel(wav, cfg.audio_tower.whisper.n_mels)
        n_tok = [generator.token_count(d, t["asr_tokens_per_s"],
                                       t["asr_tokens_max"]) for d in durations]
        n_s3 = [generator.token_count(d, t["s3_per_s"], t["s3_max"])
                for d in durations]
        ids, lengths, words = inputs.token_rows(
            n_tok, t["asr_tokens_max"], cfg.audio_tower.whisper.vocab_size,
            gen, self.dev)
        s3 = cfg.speech_decoder
        s3_ids, s3_len, _ = inputs.token_rows(n_s3, t["s3_max"],
                                              s3.speech_token_size, gen,
                                              self.dev, low=0,
                                              high=s3.speech_token_size)
        batch = {"speaker_embeds": torch.randn((b, s3.spk_embed_dim),
                                               generator=gen, device=self.dev),
                 "asr_token_ids": ids, "asr_token_lengths": lengths,
                 "asr_word_ids": words, "audio_features": mel,
                 "speech_token_ids": s3_ids, "speech_token_lengths": s3_len}
        pin = self.dev.type == "cuda"
        return {k: (v.cpu().pin_memory() if pin else v.cpu())
                for k, v in batch.items()}

    def _draws(self, i: int, batch) -> Dict:
        """Step i's RVQ draws: the quantize-dropout level and, per level,
        codebook-size dead-code picks among the batch's valid rows."""
        q = self.cfg.audio_tower.quantizer
        rng = random.Random(f"{self.seed}:draws{i}")
        lengths = batch["asr_token_lengths"]
        width = batch["asr_token_ids"].shape[1]
        valid = [r * width + c for r in range(len(lengths))
                 for c in range(int(lengths[r]))]
        picks = [[rng.choice(valid) for _ in range(q.codebook_size)]
                 for _ in range(q.num_quantizers)]
        return {"drop_after": rng.randrange(q.quantize_dropout_cutoff_index,
                                            q.num_quantizers),
                "dead_picks": torch.tensor(picks, device=self.dev)}

    def _run(self, i: int):
        host = self.pool[i % len(self.pool)]
        batch = {k: v.to(self.dev, non_blocking=True) for k, v in host.items()}
        return self.step(batch, self._draws(i, host))

    # -- the window -------------------------------------------------------

    def window(self, seconds: float) -> Dict:
        from taste_spokenlm_tpu_torch import kernels
        kernels.reset_launch_counts()
        i = self.traffic["first_steps"]
        t0 = time.perf_counter()
        ends = [t0]
        while True:
            metrics = self._run(i)
            loss = float(metrics["loss"])
            end = time.perf_counter()
            ends.append(end)
            i += 1
            if end - t0 >= seconds:
                break
        del loss
        self.launches = kernels.launch_counts()
        self.window_steps = i - self.traffic["first_steps"]
        self.window_s = end - t0
        return {"attempted": self.window_steps, "failed": 0,
                "metrics": {"stage1_audio_s_per_s":
                            self.window_steps * self.batch_audio_s
                            / self.window_s},
                "step_s": [b - a for a, b in zip(ends, ends[1:])]}

    def release(self) -> None:
        del self.model, self.opt, self.step
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- per-layer context ------------------------------------------------

    def shapes(self) -> Dict:
        """The window's work by part of the model (portbench/rooflines/):
        each step's frozen encoder forward and S3 training pass."""
        t = self.traffic
        _, width = program.element_bytes(self.cell["config_file"])
        out = {"cfg": self.cfg, "encoder": [], "s3_train": []}
        first = t["first_steps"]
        for i in range(first, first + self.window_steps):
            batch = self.pool[i % len(self.pool)]
            rows = batch["asr_token_ids"].shape[0]
            out["encoder"].append({"rows": rows, "bytes": width})
            out["s3_train"].append({
                "rows": rows, "bytes": width,
                "width": 3 + t["asr_tokens_max"] + t["s3_max"],
                "lengths": [3 + a + s for a, s in zip(
                    batch["asr_token_lengths"].tolist(),
                    batch["speech_token_lengths"].tolist())]})
        return out

    def layer_context(self) -> Dict:
        from portbench.flops import ModelFlops
        counter = ModelFlops(program.taste_configs(
            self.cell["config_file"], self.tiny)[1].to_dict())
        first = self.traffic["first_steps"]
        model_flops = 0.0
        for i in range(first, first + self.window_steps):
            batch = self.pool[i % len(self.pool)]
            for a, s in zip(batch["asr_token_lengths"].tolist(),
                            batch["speech_token_lengths"].tolist()):
                model_flops += counter.encoder() + 3 * (
                    counter.segmenter(a) + counter.s3_row(a, s))
        return {"spans": self.spans.seconds, "launches": self.launches,
                "model_flops": model_flops, "shapes": self.shapes()}

    # -- correct ----------------------------------------------------------

    def verify(self) -> Dict[str, Dict]:
        from taste_spokenlm_tpu_torch.train import optim
        from portbench.reference import pipeline
        from portbench.reference.train_ref import Stage1Reference, leaf_gaps
        layout = self.cell["config_file"]["layout"]
        limits = self.cell["workload"]["limits"]
        t = self.traffic
        ref_cfg = pipeline.reference_config(program.taste_configs(
            self.cell["config_file"], self.tiny)[1].to_dict())
        sd = inputs.seeded_state_dict(self.meta, self.seed, self.dev,
                                      prefixes=("audio_tower.",
                                                "speech_decoder."))
        p0 = {n: sd[n].float() for n in self.names}
        mods = pipeline.build(ref_cfg, sd, parts=("tower", "s3"),
                              device=self.dev)
        del sd
        ref = Stage1Reference(
            mods["tower"], mods["s3"], optim.STAGE1_PHASES[layout["phase"]],
            layout["learning_rate"], layout["grad_clip"],
            {n: p.dtype for n, p in self.meta.named_parameters()},
            t["reference_block_rows"])
        losses, first_grad = [], None
        with pipeline.matmul_precision(False):
            for i in range(t["first_steps"]):
                host = self.pool[i]
                batch = {k: v.to(self.dev) for k, v in host.items()}
                out = ref.step(batch, self._draws(i, host))
                losses.append((out["loss"], out["commit"]))
                if i == 0:
                    first_grad = {n: float(g.norm())
                                  for n, g in out["grads"].items()}
        b1 = self.cell["config_file"]["layout"].get("b1", 0.9)
        prog_grad = {n: float(m.norm()) / (1 - b1)
                     for n, m in zip(self.names, self.first_mu)}
        prog_change = {n: float((self.after_first[n].to(self.dev) - p0[n])
                                .norm()) for n in self.names}
        ref_change = {n: float((ref.params[n].detach() - p0[n]).norm())
                      for n in self.names}
        # every step's loss is printed beside, not compared: after the
        # first step the RVQ's EMA re-seeds its dead codes from residual
        # rows, and the commit loss moves with rounding (PERF.md §2)
        for i, (a, b) in enumerate(zip(self.first_losses, losses)):
            print(f"step {i + 1}: loss {a[0]!r} (reference {b[0]!r}), commit "
                  f"{a[1]!r} (reference {b[1]!r}), loss gap "
                  f"{abs(a[0] - b[0]) / abs(b[0])!r}", file=sys.stderr)
        checks = {"first_grad_leaf_gap": leaf_gaps(prog_grad, first_grad,
                                                   first_grad),
                  "change_leaf_gap": leaf_gaps(prog_change, ref_change,
                                               first_grad)}
        return {k: {"value": v, "limit": limits[k]}
                for k, v in checks.items()}
