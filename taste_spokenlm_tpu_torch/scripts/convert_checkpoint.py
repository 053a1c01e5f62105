"""Reference checkpoints -> a checkpoint directory of the port, and back
(counterpart of the JAX repo's scripts/convert_checkpoint.py).

Import: an HF whisper dir (the tokenizer tower), an HF Llama dir (the
spoken LM's backbone; model.safetensors or pytorch_model.bin, plain or
PEFT-wrapped names), a taste_speech composite checkpoint (RVQ, speech
decoder, bridges; the Llama too, in PEFT names), CosyVoice flow.pt and
hift.pt, merged into the port's names (convert_import.py) and written as a
`pretrained.save_pretrained` directory that `from_pretrained` loads with
strict=True:

    python -m taste_spokenlm_tpu_torch.scripts.convert_checkpoint \\
        --whisper whisper-large-v3/ --llama Llama-3.2-1B/ --taste taste.bin \\
        --flow flow.pt --hift hift.pt --output ./converted

The serving transforms (JAX's flags): --merge-lora, --quantize-llama,
--quantize-s3-decoder, --fuse-qkv, --fused-mlp; and --quantize-embed
(int8 | int4head), which JAX's quantizer has and its CLI does not expose:
the tied head's int8 table and, with int4head, its nibble-packed copy, as
bench.py's serving layout stores them.  The written config.json reflects
every transform.  The transforms run on --device (default CUDA; --device
cpu, or --platform cpu), where the model is built for the strict check.

Export (--export-torch DIR): a directory of the port -> a reference-named
pytorch_model.bin (JAX's export.composite_taste_state names; a serving
layout dequantized first) beside its config.json.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from typing import Dict, Optional

import torch


def serving_transforms(state: Dict[str, torch.Tensor], cfg, *,
                       merge_lora: bool = False, quantize_llama: bool = False,
                       quantize_s3_decoder: bool = False,
                       fuse_qkv: bool = False, fused_mlp: bool = False,
                       quantize_embed: Optional[str] = None):
    """The float state dict and its config -> (the state dict, the config)
    of the serving layout the flags ask for, in JAX's order: merge the
    LoRA adapters, quantize the Llama (and its tied table), quantize the S3
    llm stack and its head."""
    from taste_spokenlm_tpu_torch import quant
    from taste_spokenlm_tpu_torch.config import LoraConfig
    lm_pre, llm_pre = "spoken_lm.language_model.", "speech_decoder.llm."
    head = "speech_decoder.llm_decoder"

    def split(pre):
        sub = {k[len(pre):]: v for k, v in state.items() if k.startswith(pre)}
        rest = {k: v for k, v in state.items() if not k.startswith(pre)}
        return sub, rest

    if merge_lora or quantize_llama:
        lm, rest = split(lm_pre)
        if not lm:
            raise SystemExit("--merge-lora / --quantize-llama need a spoken-LM "
                             "backbone (--llama or a composite --taste)")
        if merge_lora:
            lora = cfg.spoken_lm.lora or LoraConfig()
            lm = quant.merge_lora_params(lm, lora.alpha, lora.r)
        if quantize_llama:
            lm = quant.quantize_llama_params(
                lm, include_embed=quantize_embed is not None,
                embed_head_mode=quantize_embed or "int8", fuse_qkv=fuse_qkv,
                fused_mlp=fused_mlp)
        state = {**rest, **{lm_pre + k: v for k, v in lm.items()}}
    if quantize_s3_decoder:
        llm, rest = split(llm_pre)
        if not llm:
            raise SystemExit("--quantize-s3-decoder needs a speech decoder "
                             "(--taste)")
        llm = quant.quantize_encoder_params(llm, fuse_qkv=fuse_qkv,
                                            fused_mlp=fused_mlp)
        state = {**rest, **{llm_pre + k: v for k, v in llm.items()}}
        if f"{head}.weight" in state:    # the logits head rides the same flag
            q = quant.quantize_dense_leaf(state, head)
            state = {k: v for k, v in state.items()
                     if not k.startswith(head + ".")}
            state.update(q)

    if merge_lora:
        cfg = cfg.replace(spoken_lm=cfg.spoken_lm.replace(use_lora=False))
    if quantize_llama:
        cfg = cfg.replace(spoken_lm=cfg.spoken_lm.replace(
            llama=cfg.spoken_lm.llama.replace(
                quantized_serving="int8", fused_qkv_serving=fuse_qkv,
                fused_mlp_serving=fused_mlp,
                quantized_embed_serving={"int8": True, "int4head": "int4head"
                                         }.get(quantize_embed, False))))
    if quantize_s3_decoder:
        cfg = cfg.replace(speech_decoder=cfg.speech_decoder.replace(
            llm=cfg.speech_decoder.llm.replace(
                quantized_serving="int8", fused_qkv_serving=fuse_qkv,
                fused_mlp_serving=fused_mlp)))
    return state, cfg


def export_torch(ckpt_dir: str, output: str) -> Dict:
    """A directory of the port -> output/pytorch_model.bin (reference
    names) and its config.json."""
    from taste_spokenlm_tpu_torch import convert_import
    from taste_spokenlm_tpu_torch.pretrained import (CONFIG_FILE, WEIGHTS_FILE,
                                                     load_config)
    cfg = load_config(ckpt_dir)
    sd = torch.load(os.path.join(ckpt_dir, WEIGHTS_FILE), map_location="cpu",
                    weights_only=True)
    state = {k: v.contiguous() for k, v in
             convert_import.export_state(sd, cfg).items()}
    os.makedirs(output, exist_ok=True)
    torch.save(state, os.path.join(output, "pytorch_model.bin"))
    shutil.copy(os.path.join(ckpt_dir, CONFIG_FILE),
                os.path.join(output, CONFIG_FILE))
    n = sum(v.numel() for v in state.values())
    print(f"exported {len(state)} tensors ({n / 1e6:.1f}M values) to "
          f"{output}/pytorch_model.bin", flush=True)
    return {"tensors": len(state), "values": n}


def _base_config(args):
    """--config > an existing config.json in --output > TasteConfig.full()."""
    from taste_spokenlm_tpu_torch.config import TasteConfig
    path = args.config or os.path.join(args.output, "config.json")
    if args.config or os.path.exists(path):
        with open(path) as f:
            return TasteConfig.from_dict(json.load(f))
    return TasteConfig.full()


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--whisper", help="HF whisper dir (the tokenizer tower)")
    p.add_argument("--llama", help="HF llama dir or weights file (the "
                                   "spoken LM backbone)")
    p.add_argument("--taste", help="taste_speech composite checkpoint")
    p.add_argument("--flow", help="CosyVoice flow.pt")
    p.add_argument("--hift", help="CosyVoice hift.pt")
    p.add_argument("--output", required=True)
    p.add_argument("--export-torch", metavar="CKPT_DIR",
                   help="the export direction: a directory of the port -> "
                        "reference-named pytorch_model.bin in --output")
    p.add_argument("--merge-lora", action="store_true",
                   help="merge the LoRA adapters into the backbone (W + "
                        "alpha/r A B) and drop them; before --quantize-llama")
    p.add_argument("--quantize-llama", action="store_true",
                   help="the backbone's projections as int8 + per-channel "
                        "scales")
    p.add_argument("--quantize-s3-decoder", action="store_true",
                   help="the S3 llm stack and its logits head as int8")
    p.add_argument("--fuse-qkv", action="store_true",
                   help="q/k/v (and gate/up) in one kernel each")
    p.add_argument("--fused-mlp", action="store_true",
                   help="the MLPs as the fused-MLP kernels' layout")
    p.add_argument("--quantize-embed", choices=["int8", "int4head"],
                   help="with --quantize-llama: the tied table as int8 "
                        "(int4head: and the head's nibble-packed copy)")
    p.add_argument("--config", help="config.json to start from (default: "
                                    "--output's, else TasteConfig.full())")
    p.add_argument("--device", default=None,
                   help="where the transforms and the strict check run "
                        "(default cuda)")
    p.add_argument("--platform", default=None,
                   help="JAX's flag: 'cpu' means --device cpu")
    args = p.parse_args(argv)

    if args.export_torch:
        return export_torch(args.export_torch, args.output)

    from taste_spokenlm_tpu_torch import convert_import
    from taste_spokenlm_tpu_torch.device import resolve_device
    from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM
    from taste_spokenlm_tpu_torch.pretrained import (LM_DTYPE_KEY,
                                                     TOWER_DTYPE_KEY,
                                                     save_pretrained)
    if args.quantize_embed and not args.quantize_llama:
        p.error("--quantize-embed goes with --quantize-llama")
    dev = resolve_device(args.device or (
        "cpu" if args.platform == "cpu" else None))
    cfg = _base_config(args)

    sources = {}
    for name in ("whisper", "llama", "taste", "flow", "hift"):
        path = getattr(args, name)
        if path:
            sources[name] = convert_import.load_weights(path)
            print(f"read {name}: {len(sources[name])} tensors from {path}",
                  flush=True)
    state = convert_import.import_checkpoint(**sources)
    del sources
    state = {k: v.to(dev) for k, v in state.items()}
    state, cfg = serving_transforms(
        state, cfg, merge_lora=args.merge_lora,
        quantize_llama=args.quantize_llama,
        quantize_s3_decoder=args.quantize_s3_decoder, fuse_qkv=args.fuse_qkv,
        fused_mlp=args.fused_mlp, quantize_embed=args.quantize_embed)

    # the model the config describes, at the dtypes of the weights (the
    # LM's and the tower's), loaded strictly: what from_pretrained rebuilds
    dtype = state[LM_DTYPE_KEY].dtype if LM_DTYPE_KEY in state \
        else torch.float32
    tower_dtype = state[TOWER_DTYPE_KEY].dtype if TOWER_DTYPE_KEY in state \
        else dtype
    with torch.device(dev):
        model = TasteForCausalLM(cfg, dtype=dtype, tower_dtype=tower_dtype,
                                 device=dev)
    missing, unexpected = model.load_state_dict(state, strict=False)
    if missing or unexpected:
        sys.exit(f"the converted weights do not fit the config: missing "
                 f"{sorted(missing)[:8]} ({len(missing)}), unexpected "
                 f"{sorted(unexpected)[:8]} ({len(unexpected)})")
    del state
    save_pretrained(model, args.output)
    n = sum(t.numel() for t in model.state_dict().values())
    print(f"saved {args.output} ({n / 1e6:.1f}M values, {dtype} / "
          f"{tower_dtype})", flush=True)
    return {"values": n, "config": cfg}


if __name__ == "__main__":
    main()
