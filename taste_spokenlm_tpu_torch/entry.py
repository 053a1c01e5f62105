"""The port's entry point for a harness that runs one forward
(counterpart of the JAX repo's __graft_entry__.entry).

entry() -> (fn, example_args): the stage-1 speech-autoencoder forward of
the composite model (whisper tower + RVQ + speech decoder, the training
hot path) at TasteConfig.tiny(), on the device asked for (default CUDA;
"cpu" for the plain versions).  `fn(model, *batch)` -> (loss,
speech_token_accuracy); example_args = (model, *batch), the model with
create_seed_model's seeded weights and JAX's tiny batch (RandomState(0),
two rows).

dryrun_multichip(n) (counterpart of __graft_entry__.dryrun_multichip): one
stage-1, one stage-2 and one flow step of the tiny model over n processes
on a ("data", "model") mesh, printing JAX's three lines.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
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


DRYRUN_TIMEOUT_S = 600      # each process of dryrun_multichip


def free_port() -> int:
    """A free localhost TCP port (a process group's rendezvous)."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dryrun_multichip(n: int, device: Optional[Union[str, torch.device]] = None
                     ) -> None:
    """One stage-1 step (the rvq phase's mask), one stage-2 step (the
    LoRA-only mask, chunked CE with the in-graph KL to the frozen base) and
    one flow step (OT-CFM) of TasteConfig.tiny() over `n` processes, on a
    (n / model, model) mesh with model = 2 when n is even and >= 4, as
    JAX's dryrun_multichip.  Each process holds the whole model (training
    replicates along "model") and its data rank's rows of a global batch of
    2 x data rows.  Prints JAX's three lines (mesh, loss, grad_norm; the
    stage-2 text_kl; the flow's loss) from rank 0 and raises if a process
    fails or a loss is not finite.  `device` None runs on CUDA: the ranks
    take the cards in turn, over nccl when each has its own card and over
    gloo when they share one (the run says so); "cpu" runs gloo on the
    CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu'")
    backend = "gloo"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if cards >= n:
            backend = "nccl"
        else:
            print(f"dryrun_multichip({n}): {n} ranks share {cards} card(s) "
                  "over gloo", flush=True)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    env.pop("WORLD_SIZE", None)
    if dev.type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys; from taste_spokenlm_tpu_torch."
         "entry import _dryrun_rank; _dryrun_rank(*sys.argv[1:])",
         str(r), str(n), str(port), dev.type, backend],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DRYRUN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if failed:
        r = failed[0][0]
        raise RuntimeError(f"dryrun_multichip({n}): ranks {failed} failed; "
                           f"rank {r}:\n{outs[r][-3000:]}")
    for line in outs[0].splitlines():
        if line.startswith("dryrun_multichip"):
            print(line, flush=True)


def _dryrun_rank(rank: str, n: str, port: str, device: str,
                 backend: str) -> None:
    """One process of dryrun_multichip."""
    import math

    from taste_spokenlm_tpu_torch.config import TasteConfig
    from taste_spokenlm_tpu_torch.models.flow import MaskedDiffWithXvec
    from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM
    from taste_spokenlm_tpu_torch.parallel import mesh
    from taste_spokenlm_tpu_torch.scripts._cli import to_device
    from taste_spokenlm_tpu_torch.scripts.create_seed_model import (
        seed_state_dict)
    from taste_spokenlm_tpu_torch.train import optim, train_step
    rank, n = int(rank), int(n)
    torch.set_num_threads(1)
    mesh.init_distributed(f"localhost:{port}", n, rank, torch.device(device),
                          backend)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device("cpu"))
    model_axis = 2 if n % 2 == 0 and n >= 4 else 1
    m = mesh.make_mesh(n // model_axis, model_axis)
    cfg = TasteConfig.tiny()
    b = max(2, 2 * m.data)

    def finite(metrics):
        vals = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in vals.values()):
            raise RuntimeError(f"rank {rank}: non-finite metrics {vals}")
        return vals

    def local(batch):
        return mesh.local_rows(to_device(batch, dev))

    def seeded(module):
        module.load_state_dict(seed_state_dict(
            module, torch.Generator(device=dev).manual_seed(0)), strict=True)
        return module.train()

    # stage 1: the rvq phase (JAX's unfreeze patterns)
    model = seeded(TasteForCausalLM(cfg, device=dev))
    mask = optim.trainable_mask(model, optim.STAGE1_PHASES["rvq"])
    opt = optim.make_optimizer(model, optim.warmup_lr(1.6e-4, 10), mask=mask,
                               grad_clip=5.0)
    step = train_step.make_stage1_step(model, opt, trainable_mask=mask)
    m1 = finite(step(local(tiny_batch(cfg, b))))
    if rank == 0:
        print(f"dryrun_multichip({n}): mesh={m.shape} loss={m1['loss']:.4f} "
              f"grad_norm={m1['grad_norm']:.4f}", flush=True)

    # stage 2: LoRA-only, chunked CE + the in-graph frozen-base KL
    rng = np.random.RandomState(2)
    t = 7
    q = cfg.audio_tower.quantizer
    idx = np.full((b, t, q.num_quantizers), -1, np.int32)
    idx[:, ::2] = rng.randint(0, q.codebook_size,
                              (b, (t + 1) // 2, q.num_quantizers))
    batch2 = {"llm_indices": idx,
              "llm_token_ids": rng.randint(2, cfg.spoken_lm.llama.vocab_size,
                                           (b, t)),
              "llm_token_lengths": np.full((b,), t),
              "llm_word_ids": np.minimum(np.arange(t) // 2, 6)[None].repeat(
                  b, 0)}
    mask2 = optim.lora_only_mask(model)
    opt2 = optim.make_optimizer(model, optim.warmup_lr(5e-5, 10), mask=mask2,
                                grad_clip=5.0)
    step2 = train_step.make_stage2_step(model, opt2, use_ref_kl=True,
                                        trainable_mask=mask2)
    m2 = finite(step2(local(batch2)))
    if rank == 0:
        print(f"dryrun_multichip({n}) stage2: loss={m2['loss']:.4f} "
              f"text_kl={m2['text_kl']:.4f} "
              f"grad_norm={m2['grad_norm']:.4f}", flush=True)

    # the flow's OT-CFM step
    fc = cfg.flow
    t_tok, t_mel = 12, 16
    batch3 = {"speech_token_ids": rng.randint(0, fc.vocab_size, (b, t_tok)),
              "speech_token_lengths": np.full((b,), t_tok),
              "feat": rng.randn(b, t_mel, fc.output_size).astype(np.float32),
              "feat_lengths": np.full((b,), t_mel),
              "embedding": rng.randn(b, fc.spk_embed_dim).astype(np.float32)}
    with torch.device(dev):
        flow = seeded(MaskedDiffWithXvec(fc).to(dev))
    opt3 = optim.make_optimizer(flow, optim.warmup_lr(1e-4, 10),
                                grad_clip=5.0)
    step3 = train_step.make_flow_step(flow, opt3)
    m3 = finite(step3(local(batch3)))
    if rank == 0:
        print(f"dryrun_multichip({n}) flow: loss={m3['loss']:.4f} "
              f"grad_norm={m3['grad_norm']:.4f}", flush=True)
    mesh.barrier()
    torch.distributed.destroy_process_group()
