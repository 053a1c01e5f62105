"""Every file that defines the benchmark parses and holds together:
BENCHMARK.json against its contract, each configuration, cell, traffic and
metric file, and the cells each per-layer metric names."""

import importlib
import json
import os
import re

import pytest

from portbench import common

ROOT = common.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH_KEY = re.compile(r"(hidden|intermediate|latent|state|proj|_dim$|_rank$|"
                       r"head|expan|per_tok|d_model|ffn|units|channels)")


def bench():
    return common.load_json(common.BENCHMARK)


def test_benchmark_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) <= 64 * 1024
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in b[key]]
    assert all(NAME.match(n) for n in names), names
    for key in ("configs", "workloads"):
        assert len({x["name"] for x in b[key]}) == len(b[key])
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in [
            (v["config"], v["traffic"]) for v in b["workloads"] if v is not w]


@pytest.mark.parametrize("metric", bench()["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    if metric["name"] == "setup_s":
        assert "workloads" not in metric


@pytest.mark.parametrize("metric", bench()["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric_reads_and_moves(metric):
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert metric["moves"] in e2e
    assert metric["workloads"], "every per-layer metric lists its cells"
    for cell in metric["workloads"]:
        assert cell in {w["name"] for w in b["workloads"]}
        assert cell in e2e[metric["moves"]].get("workloads", [cell])
    base = metric["name"].split(".")[0]
    reader = importlib.import_module(f"portbench.metrics.{base}")
    assert callable(reader.read)
    assert reader.read({}, metric["name"].partition(".")[2]) is None
    if base.endswith("_roofline"):
        assert metric["unit"] == "%"
        importlib.import_module(f"portbench.rooflines.{base[:-9]}")
    layers = {m["layer"] for m in b["per_layer"]}
    assert all("\n" not in x and len(x) <= 200 for x in layers)


@pytest.mark.parametrize("cell", bench()["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    spec = common.cell_spec(cell["name"])
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]
    entry = importlib.import_module(
        f"portbench.entries.{spec['workload']['entry']}")
    assert hasattr(entry, "Cell")
    traffic = common.load_json(os.path.join(common.PKG_DIR, "traffic",
                                            cell["traffic"] + ".json"))
    assert "tiny" in traffic
    assert spec["workload"]["limits"]


@pytest.mark.parametrize("config", bench()["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert config["file"].startswith("portbench/configs/")
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    data = common.load_json(os.path.join(ROOT, config["file"]))
    assert data["name"] == config["name"]
    assert data["reduced"] == config["reduced"]
    assert not any(WIDTH_KEY.search(k) for k in config["reduced"])
    from taste_spokenlm_tpu_torch.config import TasteConfig
    # the files hold the float configuration at its published widths
    assert TasteConfig.from_dict(data["model"]).to_dict() == data["model"]
    assert data["model"] == json.loads(json.dumps(
        TasteConfig.full().to_dict()))


def test_every_config_is_used():
    b = bench()
    assert {c["name"] for c in b["configs"]} == {w["config"]
                                                 for w in b["workloads"]}


@pytest.mark.parametrize("config", bench()["configs"], ids=lambda c: c["name"])
def test_config_layout_is_derived(config):
    """The as-run model is the file's float model put in the stated
    layout, at full size as at TasteConfig.tiny(), by one derivation; the
    full-size one is what the card ran (the layouts of chip_smoke.py's
    `configs` and `train_path`)."""
    from taste_spokenlm_tpu_torch import quant
    from taste_spokenlm_tpu_torch.config import TasteConfig
    from taste_spokenlm_tpu_torch.ops.remat import apply_remat
    from portbench import program
    data = common.load_json(os.path.join(ROOT, config["file"]))
    layout = data["layout"]
    for tiny in (False, True):
        ran, flt = program.taste_configs(data, tiny)
        assert flt == (TasteConfig.tiny() if tiny else TasteConfig.full())
        llm = ran.speech_decoder.llm
        if layout["kind"] == "serving":
            assert llm.quantized_serving == layout["tier"]
            assert ran.flow.fused_dit_serving and ran.hift.pallas_conv
            assert llm.fused_mlp_serving and not llm.remat
        else:
            assert llm.remat is True and ran.audio_tower.whisper.remat
            assert not llm.quantized_serving
    full = TasteConfig.full()
    if layout["kind"] == "serving":
        full = full.replace(flow=full.flow.replace(fused_dit_serving=True),
                            hift=full.hift.replace(pallas_conv=True))
        assert program.taste_configs(data)[0] == quant.serving_config(
            full, layout["tier"])
    else:
        assert program.taste_configs(data)[0] == apply_remat(full, True)
