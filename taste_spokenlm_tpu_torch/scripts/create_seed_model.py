"""Build a randomly initialized composite TASTE model and save it
(counterpart of the JAX repo's scripts/create_seed_model.py).

    python -m taste_spokenlm_tpu_torch.scripts.create_seed_model \\
        --output ./seed_model [--tiny | --config cfg.json] [--dtype bfloat16]

Writes a `pretrained.save_pretrained` directory (config.json + model.pt)
that `from_pretrained`, the CLIs and convert_checkpoint.py's
--export-torch read.  The weights are `seed_state_dict`'s, drawn on
--device (default CUDA; --device cpu or --platform cpu) from a generator
seeded 0, as JAX's draws from PRNGKey(0).  --dtype bfloat16 builds
everything but the audio tower in bf16 (the tower stays f32), as the
serving models are built: the same draws, rounded.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import torch


def seed_state_dict(model: torch.nn.Module, gen: torch.Generator) -> dict:
    """Seeded random weights for every entry of `model`'s state dict, at
    bench.py's _fill_variables scales (0.02 for matrices, 1e-3 for
    vectors), except that norm scales and Snake alphas sit near 1, their
    initial value, so activations stay O(1) and the taste indices are not
    decided by the codebook norms alone.  The CFM estimator's transformer
    blocks take fan-in scaled matrices: at 0.02 their softmax would be near
    uniform over ~900 keys.  The Llama's RMSNorm weights are 0.01 x N(0,
    1): at 1e-3 the MLPs' output never reaches the bf16 residual stream,
    and near 1 the random 16-layer Llama is chaotic in bf16.  Codebook
    statistics (cluster sizes, `initted`) are ones."""
    from taste_spokenlm_tpu_torch.models.llama import RMSNorm
    near_one, rms = set(), set()
    for name, mod in model.named_modules():
        if isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
            near_one.add(f"{name}.weight")
        elif isinstance(mod, RMSNorm):
            rms.add(f"{name}.weight")
    sd = {}
    for name, ref in model.state_dict().items():
        shape = ref.shape
        r = torch.randn(shape, generator=gen, device=ref.device)
        dit_matrix = (".estimator." in name and ref.dim() == 2
                      and (".attn1." in name or ".ff.net." in name))
        if name in near_one or name.endswith(".alpha"):
            v = 1.0 + 0.02 * r
        elif name in rms:
            v = 0.01 * r
        elif name.endswith(("cluster_size", "initted")):
            v = torch.ones(shape, device=ref.device)
        elif dit_matrix:
            v = shape[1] ** -0.5 * r
        elif ref.dim() >= 2:
            v = 0.02 * r
        else:
            v = 1e-3 * r
        sd[name] = v.to(ref.dtype)
    return sd


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--output", required=True)
    p.add_argument("--tiny", action="store_true",
                   help="the toy-sized config (tests / development)")
    p.add_argument("--config", default=None,
                   help="a config JSON (TasteConfig.to_json)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="everything but the audio tower (which stays f32)")
    p.add_argument("--device", default=None, help="default cuda")
    p.add_argument("--platform", default=None,
                   help="JAX's flag: 'cpu' means --device cpu")
    args = p.parse_args(argv)

    from taste_spokenlm_tpu_torch.config import TasteConfig
    from taste_spokenlm_tpu_torch.device import resolve_device
    from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM
    from taste_spokenlm_tpu_torch.pretrained import save_pretrained

    dev = resolve_device(args.device or (
        "cpu" if args.platform == "cpu" else None))
    if args.config:
        with open(args.config) as f:
            cfg = TasteConfig.from_dict(json.load(f))
    else:
        cfg = TasteConfig.tiny() if args.tiny else TasteConfig.full()
    dtype = getattr(torch, args.dtype)
    with torch.device(dev):
        model = TasteForCausalLM(cfg, dtype=dtype, tower_dtype=torch.float32,
                                 device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    model.load_state_dict(seed_state_dict(model, gen), strict=True)
    save_pretrained(model, args.output)
    n = sum(t.numel() for t in model.parameters())
    print(f"seed model saved to {args.output} ({n / 1e6:.1f}M params)",
          flush=True)
    return {"params": n}


if __name__ == "__main__":
    main()
