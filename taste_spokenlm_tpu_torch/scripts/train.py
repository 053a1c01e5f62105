"""Training CLI (counterpart of the JAX scripts/train.py): the stage-1
tokenizer curriculum, the stage-2 joint LM, and the flow.

    --phase text_only   stage 1: the speech decoder on text only
    --phase no_vq       stage 1: + the audio path, no quantization
    --phase rvq         stage 1: the full RVQ (default)
    --stage 2           the LoRA joint LM (adapters and bridges train)
    --model flow        the token -> mel flow (OT-CFM loss)

The flags are JAX's, plus --device (default CUDA; --device cpu, or
--platform cpu, runs the plain versions on the CPU).  Several processes
train one model data parallel (parallel/mesh.py: gloo on the CPU, nccl on
CUDA or --backend gloo for ranks that share a card, the optimizer's
moments sharded ZeRO-1), from --coordinator / --num-processes /
--process-id or torchrun's environment.  --model-parallel k lays the
processes out as a (processes / k, k) mesh, as JAX's CLI does: training
replicates along the model axis (JAX's state_shardings), so the k ranks
of a model group compute the same step on the same rows.  Checkpoints
land in <workdir>/ckpt/<step>, the metric rows in <workdir>/metrics.jsonl;
a relaunch with the same workdir resumes from the latest checkpoint and
replays the data stream to it, so the resumed run sees the batches an
uninterrupted one would.  TASTE_DEBUG_BATCH_HASH=1 prints each global
batch's md5 to stderr.  --init <dir> warm-starts from a directory of
`pretrained.save_pretrained`.

    python -m taste_spokenlm_tpu_torch.scripts.train --tiny --synthetic \\
        --device cpu --steps 20 --workdir /tmp/tt
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys


def synthetic_batches(cfg, batch_size, stage):
    """Endless random batches shaped like the data pipeline's (dev / CI)."""
    import numpy as np
    rng = np.random.RandomState(0)
    t_tok, t_sp, t_llm = 8, 12, 8
    t_mel = cfg.audio_tower.whisper.max_source_positions * 2
    while True:
        if stage == 1:
            yield {
                "speaker_embeds": rng.randn(
                    batch_size, cfg.speech_decoder.spk_embed_dim).astype("f4"),
                "asr_token_ids": rng.randint(
                    5, cfg.audio_tower.whisper.vocab_size,
                    (batch_size, t_tok)).astype("i4"),
                "asr_token_lengths": np.full((batch_size,), t_tok, "i4"),
                "asr_word_ids": np.tile((np.arange(t_tok) // 2)[None],
                                        (batch_size, 1)).astype("i4"),
                "audio_features": rng.randn(
                    batch_size, cfg.audio_tower.whisper.n_mels,
                    t_mel).astype("f4"),
                "speech_token_ids": rng.randint(
                    0, cfg.speech_decoder.speech_token_size,
                    (batch_size, t_sp)).astype("i4"),
                "speech_token_lengths": np.full((batch_size,), t_sp, "i4"),
            }
        else:
            yield {
                "llm_indices": rng.randint(
                    -1, cfg.audio_tower.quantizer.codebook_size,
                    (batch_size, t_llm, cfg.audio_tower.quantizer.num_quantizers)
                ).astype("i4"),
                "llm_token_ids": rng.randint(
                    2, cfg.spoken_lm.llama.vocab_size,
                    (batch_size, t_llm)).astype("i4"),
                "llm_token_lengths": np.full((batch_size,), t_llm, "i4"),
                "llm_word_ids": np.tile((np.arange(t_llm) // 2)[None],
                                        (batch_size, 1)).astype("i4"),
            }


def synthetic_flow_batches(cfg, batch_size):
    """Endless random flow batches (dev / CI): S3 tokens, CosyVoice mel
    targets and x-vectors, shaped like data.dataset.FlowDataset's."""
    import numpy as np
    rng = np.random.RandomState(0)
    fc = cfg.flow
    t_tok, t_mel = 16, 24
    while True:
        yield {
            "speech_token_ids": rng.randint(
                0, fc.vocab_size, (batch_size, t_tok)).astype("i4"),
            "speech_token_lengths": np.full((batch_size,), t_tok, "i4"),
            "feat": rng.randn(batch_size, t_mel, fc.output_size).astype("f4"),
            "feat_lengths": np.full((batch_size,), t_mel, "i4"),
            "embedding": rng.randn(
                batch_size, fc.spk_embed_dim).astype("f4"),
        }


# Every process reads every shard and builds the same global batches (the
# stream is a function of the seed and the epoch); each trains on its rows
# of them (mesh.local_rows), as every JAX process holds the full global
# batch (parallel/mesh.py global_batch).
_GLOBAL_STREAM = {"host_index": 0, "host_count": 1}


def _expand_globs(patterns):
    import glob
    files = []
    for pat in patterns:
        hits = sorted(glob.glob(pat))
        files.extend(hits if hits else [pat])
    return files


def flow_batches(args, cfg):
    """Endless epochs of flow batches from TASTE-Dump arrow shards (audio
    -> 22.05 kHz -> CosyVoice mel; s3_token; spk_emb): the global batches
    (_GLOBAL_STREAM)."""
    from taste_spokenlm_tpu_torch.data.dataset import FlowDataset

    if not args.data:
        raise SystemExit("--data <arrow shards> is required without --synthetic")
    ds = FlowDataset(
        _expand_globs(args.data), **_GLOBAL_STREAM, seed=args.seed,
        token_budget=args.token_budget, n_mels=cfg.flow.output_size,
        token_frame_rate=cfg.flow.input_frame_rate)
    for epoch in itertools.count():
        yield from ds.batches(epoch)


def stage1_batches(args, cfg):
    """Endless epochs over the TASTE-Dump arrow shards (bucket-batched, the
    global batches: _GLOBAL_STREAM): the real-data stage-1 path."""
    from transformers import AutoTokenizer

    from taste_spokenlm_tpu_torch.data.dataset import Stage1Dataset
    from taste_spokenlm_tpu_torch.frontend.processor import TasteProcessor

    if not args.data:
        raise SystemExit("--data <arrow shards> is required without --synthetic")
    if not (args.asr_tokenizer and args.llm_tokenizer):
        raise SystemExit("--asr-tokenizer/--llm-tokenizer local dirs are "
                         "required for the real-data path")
    proc = TasteProcessor(
        asr_tokenizer=AutoTokenizer.from_pretrained(args.asr_tokenizer),
        llm_tokenizer=AutoTokenizer.from_pretrained(args.llm_tokenizer),
        device="cpu")
    ds = Stage1Dataset(
        _expand_globs(args.data),
        tokenize_fn=lambda text: proc.process_text(text=text),
        **_GLOBAL_STREAM, seed=args.seed, token_budget=args.token_budget,
        n_mels=cfg.audio_tower.whisper.n_mels,
        mel_frames=2 * cfg.audio_tower.whisper.max_source_positions)
    for epoch in itertools.count():
        yield from ds.batches(epoch)


def stage2_batches(args):
    """Endless epochs over the extract_vq jsonl shards (stage 2): the
    global batches (_GLOBAL_STREAM)."""
    from taste_spokenlm_tpu_torch.data.dataset import Stage2JsonlDataset

    if not args.stage2_data:
        raise SystemExit("--stage2-data <jsonl shards> is required for "
                         "--stage 2 without --synthetic")
    ds = Stage2JsonlDataset(
        _expand_globs(args.stage2_data), **_GLOBAL_STREAM, seed=args.seed,
        token_budget=args.token_budget)
    for epoch in itertools.count():
        yield from ds.batches(epoch)


def _pad_batch(b, n_data):
    """Bucketed batches can end with a ragged row count: pad by repeating
    the last row so the rows split evenly over the processes, with the
    padded rows' *_lengths zeroed so every loss mask drops them."""
    import numpy as np
    b = {k: np.asarray(v) for k, v in b.items()}
    n = next(iter(b.values())).shape[0]
    r = (-n) % n_data
    if r:
        b = {k: np.concatenate([v, np.repeat(v[-1:], r, axis=0)], axis=0)
             for k, v in b.items()}
        for k, v in b.items():
            if k.endswith("_lengths"):
                v[n:] = 0
    return b


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--stage", type=int, default=1, choices=[1, 2])
    p.add_argument("--model", default="taste", choices=["taste", "flow"],
                   help="taste: the stage-1/2 composite (default). "
                        "flow: the token->mel flow (OT-CFM loss)")
    p.add_argument("--phase", default="rvq",
                   choices=["text_only", "no_vq", "rvq"])
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--data", nargs="*", default=[],
                   help="stage-1 / flow arrow shard files (globs ok)")
    p.add_argument("--stage2-data", nargs="*", default=[],
                   help="stage-2 jsonl shards of extract_vq")
    p.add_argument("--asr-tokenizer", default=None,
                   help="local dir for the whisper tokenizer (AutoTokenizer)")
    p.add_argument("--llm-tokenizer", default=None,
                   help="local dir for the llama tokenizer (AutoTokenizer)")
    p.add_argument("--token-budget", type=int, default=2048,
                   help="per-batch token budget for bucket batching")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (data-parallel training)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--init", default=None,
                   help="a save_pretrained dir to warm-start from")
    p.add_argument("--workdir", default="./workdir")
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1.6e-4)
    p.add_argument("--warmup", type=int, default=5000)
    p.add_argument("--grad-clip", type=float, default=5.0)
    p.add_argument("--remat", default="off",
                   choices=["off", "full", "dots", "dots_no_batch"],
                   help="per-layer gradient checkpointing policy")
    p.add_argument("--data-parallel", type=int, default=None,
                   help="the number of processes (checked against the "
                        "group's)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="the model axis of the (data, model) mesh")
    p.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                   help="the process group's backend (default: gloo on the "
                        "CPU, nccl on CUDA; gloo for ranks sharing a card)")
    p.add_argument("--ref-kl", action="store_true",
                   help="stage 2: add the KL to the adapter-disabled "
                        "frozen base, in the same step")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--save-every", type=int, default=1000)
    p.add_argument("--platform", default=None,
                   help="JAX's flag: 'cpu' means --device cpu")
    p.add_argument("--device", default=None,
                   help="cuda (default) | cpu")
    return p.parse_args(argv)


def _load_init(path, model, prefix=""):
    """A save_pretrained dir's weights (those under `prefix`) into model."""
    import torch

    from taste_spokenlm_tpu_torch.pretrained import WEIGHTS_FILE
    state = torch.load(os.path.join(path, WEIGHTS_FILE), map_location="cpu",
                       weights_only=True)
    state = {k[len(prefix):]: v for k, v in state.items()
             if k.startswith(prefix)}
    model.load_state_dict(state, strict=True)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from taste_spokenlm_tpu_torch.config import TasteConfig
    from taste_spokenlm_tpu_torch.device import resolve_device
    from taste_spokenlm_tpu_torch.ops.remat import apply_remat, parse_remat
    from taste_spokenlm_tpu_torch.parallel import mesh
    from taste_spokenlm_tpu_torch.train import optim, train_step
    from taste_spokenlm_tpu_torch.train.trainer import Trainer, TrainerConfig

    dev = resolve_device(args.device or (
        "cpu" if args.platform == "cpu" else None))
    mesh.init_distributed(args.coordinator, args.num_processes,
                          args.process_id, dev, args.backend)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    world = mesh.world_size()
    if args.model_parallel < 1 or world % args.model_parallel:
        raise SystemExit(f"--model-parallel {args.model_parallel}: the group "
                         f"has {world} processes")
    n_data = world // args.model_parallel
    if args.data_parallel not in (None, n_data):
        raise SystemExit(f"--data-parallel {args.data_parallel}: the mesh "
                         f"has {n_data} data ranks")
    mesh.make_mesh(n_data, args.model_parallel)

    cfg = TasteConfig.tiny() if args.tiny else TasteConfig.full()
    if args.remat != "off":
        cfg = apply_remat(cfg, parse_remat(args.remat))
    schedule = optim.warmup_lr(args.lr, args.warmup)
    torch.manual_seed(0)    # the same initial weights on every process

    if args.model == "flow":
        from taste_spokenlm_tpu_torch.models.flow import MaskedDiffWithXvec
        with torch.device(dev):     # (tables made from numpy stay host)
            model = MaskedDiffWithXvec(cfg.flow).to(dev)
        if args.init:
            _load_init(args.init, model, "voice_generator.flow.")
        batches = (synthetic_flow_batches(cfg, args.batch_size)
                   if args.synthetic else flow_batches(args, cfg))
        opt = optim.make_optimizer(model, schedule, grad_clip=args.grad_clip)
        step = train_step.make_flow_step(model, opt)
    else:
        from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM
        with torch.device(dev):
            model = TasteForCausalLM(cfg, device=dev)
        if args.init:
            _load_init(args.init, model)
        if args.synthetic:
            batches = synthetic_batches(cfg, args.batch_size, args.stage)
        elif args.stage == 1:
            batches = stage1_batches(args, cfg)
        else:
            batches = stage2_batches(args)
        if args.stage == 1:
            mask = optim.trainable_mask(model,
                                        optim.STAGE1_PHASES[args.phase])
        else:
            mask = optim.lora_only_mask(model)
        opt = optim.make_optimizer(model, schedule, mask=mask,
                                   grad_clip=args.grad_clip)
        if args.stage == 1:
            step = train_step.make_stage1_step(
                model, opt, skip_vq=args.phase in ("text_only", "no_vq"),
                skip_audio_in_decoder=args.phase == "text_only",
                trainable_mask=mask)
        else:
            step = train_step.make_stage2_step(
                model, opt, use_ref_kl=args.ref_kl, trainable_mask=mask)
    first = next(batches)

    trainer = Trainer(
        TrainerConfig(total_steps=args.steps, log_every=args.log_every,
                      save_every=args.save_every, workdir=args.workdir),
        step, schedule=schedule)
    state = trainer.maybe_resume(step.state)

    # the data stream is a function of (seed, epoch): replaying it to the
    # resume step feeds a relaunched run the batches an uninterrupted run
    # sees at every step
    raw = itertools.chain([first], batches)
    for _ in range(state.step):
        next(raw)

    def device_batches():
        for b in raw:
            b = _pad_batch(b, n_data)
            if os.environ.get("TASTE_DEBUG_BATCH_HASH"):
                import hashlib
                h = hashlib.md5(b"".join(
                    np.ascontiguousarray(v).tobytes()
                    for _, v in sorted(b.items()))).hexdigest()
                print(f"batch_hash {h}", file=sys.stderr, flush=True)
            yield {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                   for k, v in mesh.local_rows(b).items()}

    trainer.fit(state, device_batches())
    if world > 1:
        torch.distributed.destroy_process_group()
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
