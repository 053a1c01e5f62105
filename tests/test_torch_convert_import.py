"""The import direction (taste_spokenlm_tpu_torch/convert_import.py and
scripts/convert_checkpoint.py) against the JAX package's utils/convert.py.

Tiny reference-named state dicts, from JAX's own exporter
(utils/export.composite_taste_state of the tiny parity model: HF whisper
names, the HF Llama in plain names as pytorch_model.bin and as
model.safetensors, the taste composite with PEFT names, flow.pt and
hift.pt), go through JAX's importer and then the port's
params_to_state_dict, and through the port's importer; the two are equal
exactly, but for HiFT's weight-normed convs, which the two collapse in
different orders (JAX (g v) / ||v||, the port v (g / ||v||), torch's own
order): there within 2 ulp of JAX's, and exactly equal to the port's
exported weights, which JAX's order does not give back.  The files are
C-contiguous, as files read from disk are.  Each serving flag
gives the bytes JAX's utils/quant gives on the same tree; the safetensors
reader reads F32 / F16 / BF16 / I64 (and what the `safetensors` package
writes).  One worker: about 20 s.
"""

import os

import jax
import numpy as np
import pytest
import torch

from taste_spokenlm_tpu.utils import convert as jconvert
from taste_spokenlm_tpu.utils import export as jexport
from taste_spokenlm_tpu.utils import quant as jquant
from taste_spokenlm_tpu_torch import convert
from taste_spokenlm_tpu_torch import convert_import as CI
from taste_spokenlm_tpu_torch.config import TasteConfig
from taste_spokenlm_tpu_torch.scripts import convert_checkpoint

from torch_parity_common import tiny_pair

HIFT = "voice_generator.hift."


@pytest.fixture(scope="module")
def pair():
    cfg, _, variables, port = tiny_pair()
    return cfg, jax.tree.map(np.asarray, variables), port


@pytest.fixture(scope="module")
def reference(pair):
    """The JAX exporter's composite, cut into the importer's files
    (numpy -> torch), and the plain-HF Llama (no adapters)."""
    cfg, variables, _ = pair
    composite = {k: torch.from_numpy(np.array(v, order="C")) for k, v in
                 jexport.composite_taste_state(variables).items()}
    files = CI.split_composite(composite)
    lm = dict(variables["params"]["spoken_lm"]["language_model"])
    base = jax.tree.map(lambda x: x, lm)
    for name, layer in base.items():
        if name.startswith("layers_"):
            for mod in ("self_attn", "mlp"):
                layer[mod] = {p: {"base": q["base"]} for p, q in
                              layer[mod].items()}
    files["plain_llama"] = {k: torch.from_numpy(np.array(v, order="C"))
                            for k, v in jexport.llama_state(base, "model.",
                                                            peft=False).items()}
    return files


def _np_sd(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def jax_import(cfg, files):
    """JAX's importer over the files, as its CLI runs it (whisper, llama,
    taste, flow, hift), -> the port's names via params_to_state_dict."""
    f = cfg.flow
    w = _np_sd(files["whisper"])
    enc = {k[len("model.encoder."):]: v for k, v in w.items()
           if k.startswith("model.encoder.")}
    dec = {k[len("model.decoder."):]: v for k, v in w.items()
           if k.startswith("model.decoder.")}
    taste = {**_np_sd(files["taste"]),
             **{f"spoken_lm.language_model.{k}": v
                for k, v in _np_sd(files["llama"]).items()}}
    vq_params, vq_state = jconvert.rvq_state(taste, "audio_tower.vq.rvq.")
    lr_layers = sum(1 for k in files["flow"]
                    if k.startswith("length_regulator.model.")
                    and k.endswith(".weight")) - 1
    lr_layers = lr_layers // 2
    params = {
        "audio_tower": {"encoder": jconvert.whisper_encoder_params(enc),
                        "decoder": jconvert.whisper_decoder_params(dec),
                        "vq": vq_params},
        "speech_decoder": jconvert.speech_decoder_params(taste),
        "spoken_lm": jconvert.spoken_lm_params(taste),
        "voice_generator": {
            "flow": jconvert.flow_params(
                {f"flow.{k}": v for k, v in _np_sd(files["flow"]).items()},
                n_blocks=f.estimator_n_blocks,
                num_mid_blocks=f.estimator_num_mid_blocks,
                n_channels=len(f.estimator_channels), lr_layers=lr_layers),
            "hift": jconvert.hift_params(
                {f"hift.{k}": v for k, v in _np_sd(files["hift"]).items()},
                num_kernels=len(cfg.hift.resblock_kernel_sizes))},
    }
    return convert.params_to_state_dict(
        {"params": params, "quantizer": {"audio_tower": {"vq": vq_state}}})


def _weight_normed(key: str) -> bool:
    return key.startswith(HIFT) and bool(
        CI._WEIGHT_NORMED.fullmatch(key[len(HIFT):]))


def test_import_matches_jax_importer(pair, reference):
    cfg, variables, port = pair
    files = {k: reference[k] for k in ("whisper", "llama", "taste", "flow",
                                       "hift")}
    got = CI.import_checkpoint(**files)
    want = jax_import(cfg, files)
    assert set(got) == set(want)
    normed = [k for k in got if _weight_normed(k)]
    assert len(normed) > 10
    for k, v in want.items():
        g = got[k].numpy()
        assert g.dtype == v.dtype, k
        if k in normed:
            np.testing.assert_array_max_ulp(g, v, maxulp=2)
        else:
            np.testing.assert_array_equal(g, v, err_msg=k)
    # the port's own export comes back exactly, weight-normed convs too
    sd = port.state_dict()
    back = CI.import_checkpoint(**CI.split_composite(CI.export_state(sd)))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    # and loads into the tiny model strictly
    fresh = type(port)(TasteConfig.tiny(), device="cpu")
    fresh.load_state_dict(got, strict=True)


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_plain_llama_file_matches_jax(tmp_path, reference, fmt):
    sd = reference["plain_llama"]
    path = str(tmp_path / ("pytorch_model.bin" if fmt == "bin"
                           else "model.safetensors"))
    if fmt == "bin":
        torch.save(sd, path)
    else:
        CI.write_safetensors(sd, path)
    loaded = CI.load_weights(str(tmp_path))             # the directory
    got = CI.llama_state(loaded)
    tree = jconvert.llama_params(_np_sd(sd), prefix="model.")
    want = convert.llama_state(tree, "spoken_lm.language_model.")
    assert set(got) == set(want) and not any(".lora_" in k for k in got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # PEFT names in a Llama file import to the same backbone + adapters
    peft = CI.llama_state(reference["llama"])
    assert {k for k in peft if ".lora_" not in k} == set(got)


def test_safetensors_reader_dtypes(tmp_path):
    r = np.random.RandomState(0)
    state = {"f32": torch.from_numpy(r.randn(3, 5).astype(np.float32)),
             "f16": torch.from_numpy(r.randn(7).astype(np.float16)),
             "bf16": torch.from_numpy(r.randn(2, 3, 4).astype(np.float32)
                                      ).bfloat16(),
             "i64": torch.from_numpy(r.randint(-2 ** 40, 2 ** 40, (4, 2))),
             "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 3)}
    path = str(tmp_path / "ours.safetensors")
    CI.write_safetensors(state, path, metadata={"format": "pt"})
    got = CI.read_safetensors(path)
    assert set(got) == set(state)
    for k, v in state.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
    st = pytest.importorskip("safetensors.torch")
    theirs = str(tmp_path / "theirs.safetensors")
    st.save_file({k: v for k, v in state.items()}, theirs)
    got = CI.read_safetensors(theirs)
    for k, v in state.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    ours_by_them = st.load_file(path)
    for k, v in state.items():
        assert torch.equal(ours_by_them[k], v), k


FLAGS = {"merge": dict(merge_lora=True),
         "llama": dict(merge_lora=True, quantize_llama=True),
         "llama_fused": dict(merge_lora=True, quantize_llama=True,
                             fuse_qkv=True, fused_mlp=True),
         "s3": dict(quantize_s3_decoder=True),
         "s3_fused": dict(quantize_s3_decoder=True, fuse_qkv=True),
         "all_int4head": dict(merge_lora=True, quantize_llama=True,
                              quantize_s3_decoder=True, fuse_qkv=True,
                              fused_mlp=True, quantize_embed="int4head"),
         "embed_int8": dict(merge_lora=True, quantize_llama=True,
                            quantize_embed="int8")}


def jax_transforms(cfg, variables, merge_lora=False, quantize_llama=False,
                   quantize_s3_decoder=False, fuse_qkv=False, fused_mlp=False,
                   quantize_embed=None):
    """JAX's CLI transforms on its tree (utils/quant), quantize_embed as
    its quantizer's include_embed / embed_head_mode."""
    params = dict(variables["params"])
    slm = dict(params["spoken_lm"])
    lm = slm["language_model"]
    if merge_lora:
        lm = jquant.merge_lora_params(lm, cfg.spoken_lm.lora.alpha,
                                      cfg.spoken_lm.lora.r)
    if quantize_llama:
        lm = jquant.quantize_llama_params(
            lm, include_embed=quantize_embed is not None,
            embed_head_mode={"int4head": "int4"}.get(quantize_embed, "int8"),
            fuse_qkv=fuse_qkv, fused_mlp=fused_mlp)
    slm["language_model"] = jax.tree.map(np.asarray, lm)
    sdec = dict(params["speech_decoder"])
    if quantize_s3_decoder:
        sdec["llm"] = jax.tree.map(np.asarray, jquant.quantize_encoder_params(
            sdec["llm"], fuse_qkv=fuse_qkv, fused_mlp=fused_mlp))
        sdec["llm_decoder"] = jax.tree.map(
            np.asarray, jquant._quantize_dense_leaf(sdec["llm_decoder"]))
    params.update(spoken_lm=slm, speech_decoder=sdec)
    return convert.params_to_state_dict(dict(variables, params=params))


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_serving_flags_match_jax_quant(pair, flags):
    """The quantizing flags byte for byte from the same (merged) floats;
    --merge-lora itself within 1e-6 relative, as
    tests/test_torch_completion.py holds it (W + s A B: the two matmuls sum
    the rank in another order)."""
    cfg, variables, port = pair
    kw = dict(FLAGS[flags])
    state, tcfg = dict(port.state_dict()), TasteConfig.tiny()
    if kw.pop("merge_lora", False):
        merged, tcfg = convert_checkpoint.serving_transforms(
            state, tcfg, merge_lora=True)
        variables = dict(variables, params=dict(
            variables["params"], spoken_lm=dict(
                variables["params"]["spoken_lm"],
                language_model=jax.tree.map(np.asarray, jquant.merge_lora_params(
                    variables["params"]["spoken_lm"]["language_model"],
                    cfg.spoken_lm.lora.alpha, cfg.spoken_lm.lora.r)))))
        state = convert.to_torch(convert.params_to_state_dict(variables))
        assert set(merged) == set(state)
        for k, v in state.items():
            np.testing.assert_allclose(merged[k].numpy(), v.numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    got, got_cfg = convert_checkpoint.serving_transforms(state, tcfg, **kw)
    want = jax_transforms(cfg, variables, **kw)
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].detach().numpy()
        assert g.dtype == v.dtype, (k, g.dtype, v.dtype)
        np.testing.assert_array_equal(g, v, err_msg=k)
    # the written config builds a model the state dict fits strictly
    model = type(port)(got_cfg, device="cpu")
    model.load_state_dict(got, strict=True)


def test_cli_import_and_export(tmp_path, pair, reference):
    """convert_checkpoint's main: the five files -> a float dir equal to
    the importer's dict; with the serving flags -> the layout of
    quant.serving_state_dict; --export-torch of the float dir -> the
    composite again."""
    from taste_spokenlm_tpu_torch import from_pretrained, quant
    cfg, variables, port = pair
    d = tmp_path / "ref"
    (d / "whisper").mkdir(parents=True)
    (d / "llama").mkdir()
    torch.save(reference["whisper"], str(d / "whisper" / "pytorch_model.bin"))
    CI.write_safetensors(reference["llama"], str(d / "llama" / "model.safetensors"))
    torch.save(reference["taste"], str(d / "taste.bin"))
    torch.save(reference["flow"], str(d / "flow.pt"))
    torch.save(reference["hift"], str(d / "hift.pt"))
    cfg_path = str(tmp_path / "config.json")
    with open(cfg_path, "w") as f:
        f.write(TasteConfig.tiny().to_json())
    src = ["--whisper", str(d / "whisper"), "--llama", str(d / "llama"),
           "--taste", str(d / "taste.bin"), "--flow", str(d / "flow.pt"),
           "--hift", str(d / "hift.pt"), "--config", cfg_path,
           "--device", "cpu"]
    convert_checkpoint.main(src + ["--output", str(tmp_path / "float")])
    model, _ = from_pretrained(str(tmp_path / "float"), device="cpu")
    want = CI.import_checkpoint(**{k: reference[k] for k in (
        "whisper", "llama", "taste", "flow", "hift")})
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k

    convert_checkpoint.main(src + [
        "--output", str(tmp_path / "int8"), "--merge-lora", "--quantize-llama",
        "--quantize-s3-decoder", "--fuse-qkv", "--fused-mlp",
        "--quantize-embed", "int4head"])
    served, _ = from_pretrained(str(tmp_path / "int8"), device="cpu")
    scfg = quant.serving_config(TasteConfig.tiny(), "int8")
    assert served.config.spoken_lm == scfg.spoken_lm
    assert served.config.speech_decoder == scfg.speech_decoder
    layout = quant.serving_state_dict(want, scfg, "int8")
    for k, v in served.state_dict().items():
        assert torch.equal(v, layout[k].to(v.dtype)), k

    convert_checkpoint.main(["--export-torch", str(tmp_path / "float"),
                             "--output", str(tmp_path / "exported")])
    exported = torch.load(str(tmp_path / "exported" / "pytorch_model.bin"),
                          weights_only=True)
    assert set(exported) == set(jexport.composite_taste_state(variables))
    assert os.path.exists(str(tmp_path / "exported" / "config.json"))
