"""The controls that the limits of `correct` are set against: the plain
reference put in the program's place and computed one precision below
what the configuration states, judged by the same comparison as the
program.  Run on the card at a cell's own size, on several seeds:

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \
        [--seconds 1]

For each seed it builds the cell, runs a short window of the program (the
served prompts, tokens and mels the control is read on), frees it, and
prints one JSON line: the program's numbers and the control's, each by
the cell's own comparison.  The benchmark's runs never run it.

- recon-batch: the tower with TF32 products (float32 stated); the S3 llm
  stack and head with int4 weights (int8 stated) and its text and audio
  encoders fp8 (bfloat16 stated), read without decoding: at each served
  position of the greedy rows, the token the control puts first; the
  flow and HiFT fp8 (bfloat16 stated).
- tokenize-serve: the tower with TF32 products.
- stage1-train: the encoder and the S3 stack fp8 (bfloat16 stated), the
  aggregator and the RVQ with TF32 products (float32 stated), through the
  same first steps; and the fault "half of the batch left out, the mean
  taken over the rest" (the reference on the first half of each batch).
"""

from __future__ import annotations

import argparse
import copy
import importlib
import json
import sys

import torch

from portbench import common, inputs, program
from portbench.reference import pipeline


def _reference(c, parts):
    ref_cfg = pipeline.reference_config(program.taste_configs(
        c.cell["config_file"], c.tiny)[1].to_dict())
    prefixes = {"tower": "audio_tower.", "s3": "speech_decoder.",
                "voice": "voice_generator."}
    sd = inputs.seeded_state_dict(c.meta, c.seed, c.dev,
                                  prefixes=[prefixes[p] for p in parts])
    return ref_cfg, sd, pipeline.build(ref_cfg, sd, parts=parts,
                                       device=c.dev)


def _tower_control(tower, args):
    """The tower with TF32 products: (its indices, its RVQ input)."""
    kept = []
    hook = tower.vq.rvq.project_in.register_forward_hook(
        lambda m, a, out: kept.append(out))
    with pipeline.matmul_precision(True), torch.no_grad():
        idx = tower(*args)["quantized_indices"]
    hook.remove()
    return idx, kept[0]


def recon_control(c) -> dict:
    ref_cfg, sd, ref = _reference(c, ("tower", "s3", "voice"))
    ctl = pipeline.build(ref_cfg, sd, device=c.dev)
    del sd
    s3 = ctl["s3"]
    pipeline.lower_precision(s3.llm, "int4")
    pipeline.lower_precision(s3.llm_decoder, "int4")
    for name in ("text_encoder", "audio_token_encoder", "text_embedding"):
        pipeline.lower_precision(getattr(s3, name), "fp8")
    pipeline.lower_precision(ctl["voice"], "fp8")
    t = c.traffic
    eos = ref_cfg.speech_decoder.speech_token_size
    worst = {"tower_err": 0.0, "s3_logit_gap": 0.0,
             "flow_mel_err": 0.0, "hift_wav_err": 0.0}
    for cc, r in c.sample():
        call, out = c.pool[cc % len(c.pool)], c.calls[cc]
        dr = {k: v[:, r:r + 1] if k == "gumbel" else v[r:r + 1]
              for k, v in c._draws(cc).items()}
        sl = slice(r, r + 1)
        args = (call["mel"][sl], call["ids"][sl], call["lengths"][sl],
                call["words"][sl])
        idx, z = _tower_control(ctl["tower"], args)
        with pipeline.matmul_precision(False):
            worst["tower_err"] = max(worst["tower_err"], pipeline.tower_err(
                ref["tower"], *args, idx, z))
            indices = out["quantized_indices"][sl]
            tokens = out["speech_token_ids"][sl].clamp(min=0)
            n = int(out["speech_token_lengths"][r])
            embeds = pipeline.audio_unit_embeds(ref["tower"], indices)
            lg_ref = pipeline.s3_logits(ref["s3"], call["spk"][sl], embeds,
                                        call["ids"][sl], call["lengths"][sl],
                                        tokens, n)
            lg_ctl = pipeline.s3_logits(s3, call["spk"][sl], embeds,
                                        call["ids"][sl], call["lengths"][sl],
                                        tokens, n)
            min_len = int((3 + int(call["lengths"][r])) * 2.0)
            g = dr["gumbel"][:n, 0]
            masked = lg_ctl.clone()
            masked[torch.arange(n, device=c.dev) < min_len, eos] = \
                float("-inf")
            firsts = (pipeline.mask_top_k(masked, t["sampling_k"]) + g
                      ).argmax(-1)
            if r in c.greedy_rows(cc):
                worst["s3_logit_gap"] = max(
                    worst["s3_logit_gap"], pipeline.s3_gap(
                        lg_ref, firsts, g, min_len, eos, t["sampling_k"]))
            with torch.no_grad():
                mel_ctl, _ = ctl["voice"].flow.inference(
                    tokens, torch.tensor([n], device=c.dev),
                    call["spk"][sl], t["mel_len_max"], z=dr["z"])
                wav_ctl = ctl["voice"].hift(out["mel"][sl].float(),
                                            dr["source_phase"],
                                            dr["source_noise"])
            worst["flow_mel_err"] = max(worst["flow_mel_err"],
                                        pipeline.flow_err(
                                            ref["voice"], tokens, n,
                                            call["spk"][sl], t["mel_len_max"],
                                            dr["z"], mel_ctl))
            frames = int(out["waveform_lengths"][r]) // c.spf
            worst["hift_wav_err"] = max(worst["hift_wav_err"],
                                        pipeline.hift_err(
                                            ref["voice"], out["mel"][sl],
                                            frames, dr["source_phase"],
                                            dr["source_noise"], wav_ctl))
    return worst


def tokenize_control(c) -> dict:
    _, sd, ref = _reference(c, ("tower",))
    ctl = copy.deepcopy(ref["tower"])
    del sd
    gap = 0.0
    served = [i for i, res in enumerate(c.results) if res and res[1] is not None]
    for i in served[:c.cell["workload"]["sample"]]:
        r = c.requests[i]
        n = len(r["ids"])
        args = (torch.as_tensor(r["mel"])[None].to(c.dev),
                torch.as_tensor(r["ids"])[None].to(c.dev).long(),
                torch.tensor([n], device=c.dev),
                torch.as_tensor(r["words"])[None].to(c.dev).long())
        idx, z = _tower_control(ctl, args)
        with pipeline.matmul_precision(False):
            gap = max(gap, pipeline.tower_err(ref["tower"], *args, idx, z))
    return {"tower_err": gap}


def stage1_control(c) -> dict:
    """The control and the half-batch fault, each through the first steps
    in the program's place, judged against the reference's run."""
    from taste_spokenlm_tpu_torch.train import optim
    from portbench.reference.train_ref import Stage1Reference, leaf_gaps
    layout = c.cell["config_file"]["layout"]
    t = c.traffic
    store = {n: p.dtype for n, p in c.meta.named_parameters()}
    phase = optim.STAGE1_PHASES[layout["phase"]]

    def run(kind):
        ref_cfg, sd, mods = _reference(c, ("tower", "s3"))
        p0 = {n: sd[n].float() for n in c.names}
        del sd
        if kind == "control":
            pipeline.lower_precision(mods["tower"].encoder, "fp8")
            pipeline.lower_precision(mods["s3"], "fp8")
        ref = Stage1Reference(mods["tower"], mods["s3"], phase,
                              layout["learning_rate"], layout["grad_clip"],
                              store, t["reference_block_rows"])
        losses, grad = [], None
        with pipeline.matmul_precision(kind == "control"):
            for i in range(t["first_steps"]):
                host = c.pool[i]
                batch = {k: v.to(c.dev) for k, v in host.items()}
                draws = c._draws(i, host)
                if kind == "half":
                    half = batch["asr_token_ids"].shape[0] // 2
                    batch = {k: v[:half] for k, v in batch.items()}
                    width = host["asr_token_ids"].shape[1]
                    draws = dict(draws, dead_picks=draws["dead_picks"]
                                 % (half * width))
                out = ref.step(batch, draws)
                losses.append(out["loss"])
                if i == 0:
                    grad = {n: float(g.norm()) for n, g in out["grads"].items()}
        change = {n: float((ref.params[n].detach() - p0[n]).norm())
                  for n in c.names}
        del ref, mods
        torch.cuda.empty_cache()
        return losses, grad, change

    base = run("reference")
    readings = {"loss_rel_gap_by_step": {}}
    for kind in ("control", "half"):
        losses, grad, change = run(kind)
        readings["loss_rel_gap_by_step"][kind] = [
            abs(a - b) / abs(b) for a, b in zip(losses, base[0])]
        readings[kind] = {
            "first_grad_leaf_gap": leaf_gaps(grad, base[1], base[1]),
            "change_leaf_gap": leaf_gaps(change, base[2], base[1])}
    return readings


CONTROLS = {"recon_batch": recon_control, "tokenize_serve": tokenize_control,
            "stage1_train": stage1_control}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    cell = common.cell_spec(args.workload)
    common.float32_as_stated()
    name = cell["workload"]["entry"]
    entry = importlib.import_module(f"portbench.entries.{name}")
    for seed in (int(s) for s in args.seeds.split(",")):
        c = entry.Cell(cell, seed, "cuda", traced=False,
                       seconds=args.seconds)
        c.setup()
        c.window(args.seconds)
        c.release()
        program_numbers = {k: v["value"] for k, v in c.verify().items()}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": program_numbers,
                          "control": CONTROLS[name](c)}), flush=True)
        del c
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
