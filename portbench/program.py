"""Building the system under test, `taste_spokenlm_tpu_torch`, from a
configuration file and the seed.  The weights are the benchmark's
(`inputs.seeded_state_dict`, drawn in the configuration's float layout on
a model built on the meta device); the program derives its own layout
from them, as a served or a trained model would be loaded."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def tuples(d):
    """A JSON config dict with its lists back as the tuples the config
    classes hold."""
    if isinstance(d, dict):
        return {k: tuples(v) for k, v in d.items()}
    if isinstance(d, list):
        return tuple(tuples(v) for v in d)
    return d


def taste_configs(config_file: Dict, tiny: bool = False):
    """(as-run config, float config) of the program: the file's float
    `model` (TasteConfig.tiny() in its place for the CPU tests) in the
    file's `layout`, as a served or a trained model is laid out: the
    serving tier with fused DiT blocks and kernel convs
    (quant.serving_config), or the training step's per-layer remat
    (apply_remat)."""
    from taste_spokenlm_tpu_torch import quant
    from taste_spokenlm_tpu_torch.config import TasteConfig
    from taste_spokenlm_tpu_torch.ops.remat import apply_remat
    layout = config_file["layout"]
    flt = TasteConfig.tiny() if tiny else \
        TasteConfig.from_dict(tuples(config_file["model"]))
    if layout["kind"] == "serving":
        return quant.serving_config(flt, layout["tier"]), flt
    return apply_remat(flt, True), flt


def element_bytes(config_file: Dict) -> Tuple[int, int]:
    """(bytes of an element in the audio tower, in the rest) of the
    layout."""
    layout = config_file["layout"]
    tower = layout.get("tower_dtype", layout["dtype"])
    return _DTYPES[tower].itemsize, _DTYPES[layout["dtype"]].itemsize


def meta_model(float_cfg, config_file: Dict):
    """The float layout's model on the meta device: the names, shapes and
    dtypes the weights are drawn for."""
    from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM
    layout = config_file["layout"]
    with torch.device("meta"):
        return TasteForCausalLM(
            float_cfg, dtype=_DTYPES[layout["dtype"]],
            tower_dtype=_DTYPES[layout.get("tower_dtype", layout["dtype"])],
            device="meta")


def build(config_file: Dict, seed: int, device, tiny: bool = False
          ) -> Tuple[torch.nn.Module, object, object]:
    """-> (model, as-run config, the float layout's meta model)."""
    from taste_spokenlm_tpu_torch import quant
    from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM
    from portbench.inputs import seeded_state_dict
    layout = config_file["layout"]
    cfg, float_cfg = taste_configs(config_file, tiny)
    meta = meta_model(float_cfg, config_file)
    sd = seeded_state_dict(meta, seed, device)
    dtype = _DTYPES[layout["dtype"]]
    tower = _DTYPES[layout.get("tower_dtype", layout["dtype"])]
    with torch.device(device):
        model = TasteForCausalLM(cfg, dtype=dtype, tower_dtype=tower,
                                 device=device)
    if layout["kind"] == "serving":
        sd = quant.serving_state_dict(sd, cfg, layout["tier"])
    model.load_state_dict(sd, strict=True)
    del sd
    return model, cfg, meta
