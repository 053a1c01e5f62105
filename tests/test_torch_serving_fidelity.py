"""The port's serving fidelity gate (taste_spokenlm_tpu_torch/scripts/
serving_fidelity.py) against the JAX script it ports
(scripts/full_arch_parity.py `run_serving` / `_serving_agreement` /
`_fill_variables_f32`).

The agreement metrics, the teacher-forced ones too, are held equal to the
JAX function's (a numpy statement) on crafted rows; the tiny run goes
through all four rows and reports every metric; the weight rule puts each
leaf of the port's model in the scale class that `_fill_variables_f32`
gives the same leaf of the JAX model; and the module imports nothing of
JAX or of the JAX package.
"""

import ast
import copy
import functools
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taste_spokenlm_tpu.config import TasteConfig as JaxTasteConfig
from taste_spokenlm_tpu.models.taste import TasteForCausalLM as JaxTaste
from taste_spokenlm_tpu_torch import convert, quant
from taste_spokenlm_tpu_torch.config import TasteConfig
from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM
from taste_spokenlm_tpu_torch.scripts import serving_fidelity

from torch_parity_common import inputs, lm_inputs

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = os.path.join(REPO, "taste_spokenlm_tpu_torch", "scripts",
                      "serving_fidelity.py")
L, K, V = 2, 3, 7          # taste levels, codebook size, text vocab


@functools.lru_cache(maxsize=1)
def _jax_script():
    """scripts/full_arch_parity.py loaded by path; the sys.path and
    environment entries it sets at import are undone."""
    path, env = list(sys.path), dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location(
            "full_arch_parity", os.path.join(REPO, "scripts",
                                             "full_arch_parity.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
        os.environ.clear()
        os.environ.update(env)
    return mod


def _row(text, n_tok, taste, n_words, speech, n_speech, mel):
    """A row as both agreement functions read it (numpy, B = 1)."""
    taste = np.asarray(taste, np.int64).reshape(1, -1, L)
    return {"jd": {"llm_token_ids": np.asarray([text]),
                   "num_tokens": np.asarray([n_tok]),
                   "num_taste_words": np.asarray([n_words]),
                   "taste_indices": taste},
            "syn": {"speech_token_ids": np.asarray([speech]),
                    "speech_token_lengths": np.asarray([n_speech])},
            "mel": np.asarray(mel, np.float32)}


def _tf(r):
    """Teacher-forced outputs of a row: random logits, every label valid."""
    return {"text_logits": r.randn(1, 5, V).astype(np.float32),
            "text_labels": np.zeros((1, 5), np.int64),
            "taste_logits": r.randn(1, 5, L, K).astype(np.float32),
            "taste_labels": np.zeros((1, 5, L), np.int64)}


def _cases():
    r = np.random.RandomState(0)
    mel = r.randn(1, 12, 4)
    text = [5, 9, 2, 2, 7, 1, 3, 3]
    taste = [[0, 1], [2, 2], [1, 0], [2, 1]]
    speech = [4, 4, 8, 1, 0, 6, 6, 2, 9, 5]
    ref = _row(text, 8, taste, 4, speech, 10, mel)
    diverged = _row(text[:3] + [0] + text[4:], 8, taste[:2] + [[0, 0]]
                    + taste[3:], 4, speech[:6] + [7, 7, 7, 7], 10,
                    mel + 0.01 * r.randn(*mel.shape))
    unequal = _row(text[:5] + [4, 4, 4], 5, taste, 3, speech[:7] + [0] * 3,
                   7, np.concatenate([mel[:, :9], mel[:, :3]], 1))
    no_words = _row(text, 8, taste, 0, speech, 10, 2 * mel)
    return {"identical": (ref, copy.deepcopy(ref)),
            "divergence at step k": (ref, diverged),
            "unequal lengths": (ref, unequal),
            "no taste words": (_row(text, 8, taste, 0, speech, 10, mel),
                               no_words)}


@pytest.mark.parametrize("case", list(_cases()))
def test_agreement_matches_jax(case):
    ref, row = _cases()[case]
    r = np.random.RandomState(1)
    ref, row = {**ref, "tf": _tf(r)}, {**row, "tf": _tf(r)}
    got = serving_fidelity.serving_agreement(ref, row)
    want = _jax_script()._serving_agreement(ref, row, 8, L)
    assert set(got) == set(want) == set(serving_fidelity.METRICS)
    assert got == want
    if case == "divergence at step k":
        assert (got["jd_first_divergence"], got["s3_first_divergence"]) == (3, 6)
    if case == "no taste words":
        assert got["jd_taste_trajectory_agreement"] is None


def _tf_pair(case):
    """(f32, row) teacher-forced outputs: the row's text logits move by
    0.05 at positions 0-3 and by 3.0 at 4-7 (decided where the f32 top-2
    margin exceeds 0.1, flipped argmaxes among the moved ones), a few
    labels ignored, the taste argmax changed at some labelled positions."""
    r = np.random.RandomState(3)
    n = 8
    text = r.randn(1, n, V).astype(np.float32) * 2
    labels = r.randint(0, V, (1, n))
    labels[0, [2, 6]] = -1
    taste = r.randn(1, n, L, K).astype(np.float32)
    taste_labels = r.randint(0, K, (1, n, L))
    taste_labels[0, 5] = -1
    moved = text.copy()
    moved[0, :4] += 0.05 * r.randn(4, V).astype(np.float32)
    moved[0, 4:] += 3.0 * r.randn(4, V).astype(np.float32)
    taste2 = taste.copy()
    taste2[0, [1, 3, 5]] = r.randn(3, L, K)
    if case == "nothing decided":
        moved = text + 50.0 * r.randn(*text.shape).astype(np.float32)
    ref = {"text_logits": text, "text_labels": labels, "taste_logits": taste,
           "taste_labels": taste_labels}
    return ref, {**ref, "text_logits": moved, "taste_logits": taste2}


@pytest.mark.parametrize("case", ["decided and not", "nothing decided"])
def test_tf_agreement_matches_jax(case):
    """The teacher-forced metrics against the JAX script's numpy formula
    (its `_serving_agreement` on the same rows)."""
    ref_tf, row_tf = _tf_pair(case)
    ref, row = _cases()["identical"]
    ref, row = {**ref, "tf": ref_tf}, {**row, "tf": row_tf}
    got = serving_fidelity.serving_agreement(ref, row)
    want = _jax_script()._serving_agreement(ref, row, 8, L)
    tf = {k: v for k, v in want.items() if k.startswith("tf_")}
    assert len(tf) == 4 and {k: got[k] for k in tf} == tf
    if case == "nothing decided":
        assert got["tf_decided_fraction"] == 0.0
        assert got["tf_text_agreement_decided"] == 1.0
    else:
        assert 0.0 < got["tf_decided_fraction"] < 1.0
        assert 0.0 < got["tf_taste_agreement"] < 1.0


def test_tiny_run_reports_every_row_and_metric():
    """All four rows (and the reach row) at TasteConfig.tiny() on the CPU,
    every metric reported; no floor is asserted at this size, as in the
    JAX script's tiny mode.  Each serving row's plain path stays within
    TWIN_TOL of its float twin here too."""
    rep = serving_fidelity.main(["--tiny", "--reach", "--device", "cpu"])
    assert list(rep["rows"]) == [*serving_fidelity.ROWS, "int8_w2_scales_x2"]
    f32 = rep["rows"]["f32"]
    assert f32["jd_tokens"] >= rep["decode_steps"] // 2
    assert f32["s3_tokens"] >= min(64, rep["max_speech_steps"] // 2)
    for name in serving_fidelity.ROWS[1:]:
        row = rep["rows"][name]
        assert set(serving_fidelity.METRICS) <= set(row)
        assert row["wav_finite"]
        assert 0.0 <= row["jd_text_trajectory_agreement"] <= 1.0
        assert 0.0 <= row["s3_trajectory_agreement"] <= 1.0
        assert np.isfinite(row["mel_rel_err"])
        # why a row parts: the f32 margins and the row's logit drift
        assert row["jd_f32_top2_margin_median"] > 0
        assert row["s3_logit_drift_median"] >= 0
        assert set(row["float_twin"]) == set(serving_fidelity.WITNESS)
        against = row["against_twin"]
        assert set(serving_fidelity.TWIN_TOL) <= set(against)
        assert against["text_shared_steps"] >= 1
        assert against["s3_shared_steps"] >= 1
        assert all(np.isfinite(against[m]) for m in serving_fidelity.TWIN_TOL)
    assert set(rep["floors"]) == {"bf16_merged", "int8", "int4"}
    assert rep["floors_pass"] == (not rep["floor_misses"])
    assert "s3_trajectory_agreement" not in rep["floors"]["int4"]
    for name in serving_fidelity.ROWS[1:]:
        row = rep["rows"][name]
        for m in ("tf_text_agreement_raw", "tf_text_agreement_decided",
                  "tf_decided_fraction", "tf_taste_agreement"):
            assert 0.0 <= row[m] <= 1.0, (name, m)
    assert "tf_taste_agreement" in rep["floors"]["int4"]
    assert "moved" in rep["reach"]
    assert "caught_by" in rep["reach"]
    assert rep["twin_misses"] == []
    assert rep["twin_tolerances"] == serving_fidelity.TWIN_TOL


@pytest.mark.parametrize("tier", ["int8", "int4"])
def test_dequantized_state_dict_holds_the_layouts_weights(tier):
    """quant.dequantized_state_dict turns a serving layout back into the
    float layout that float_layout_config describes (it loads strictly),
    and each weight is the float one to within its quantizer's half step:
    1/254 of max |w| per int8 leaf, 1/14 per int4 leaf (a misplaced tile,
    group or qkv part would be off by the weights' own size).  The
    embedding table is the int8 one and the untied head the int4 one."""
    cfg = TasteConfig.tiny()
    model = TasteForCausalLM(cfg, device="cpu")
    serving_fidelity.fill_f32(model, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    scfg = quant.serving_config(cfg, tier)
    got = quant.dequantized_state_dict(quant.serving_state_dict(sd, scfg, tier),
                                       scfg)
    twin = TasteForCausalLM(quant.float_layout_config(scfg), device="cpu")
    twin.load_state_dict(got, strict=True)
    pre, lora = "spoken_lm.language_model.", cfg.spoken_lm.lora
    want = dict(sd)
    want.update({pre + k: v for k, v in quant.merge_lora_params(
        {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)},
        lora.alpha, lora.r).items()})
    want[pre + "lm_head.weight"] = want[pre + "embed_tokens.weight"]
    bound = {"int8": 1 / 254, "int4": 1 / 14}
    changed = set()
    for k, v in got.items():
        err = (v - want[k].float()).abs().max() / want[k].float().abs().max()
        head = k.endswith("lm_head.weight")
        assert err <= (bound["int4"] if head else bound[tier]) + 1e-6, (k, err)
        if err > 0:
            changed.add(k)
    assert pre + "lm_head.weight" in changed
    assert pre + "layers.0.self_attn.k_proj.weight" in changed
    assert "speech_decoder.llm.encoders.0.feed_forward.w_2.weight" in changed
    assert "speech_decoder.llm_decoder.weight" in changed
    # nothing outside the quantized stacks' projections and heads moves
    assert all(k.startswith((pre, "speech_decoder.llm.",
                             "speech_decoder.llm_decoder."))
               and k.endswith(".weight") and "norm" not in k
               for k in changed), changed


def _scale_class(name, t):
    t = torch.as_tensor(np.asarray(t))
    if name.endswith("initted"):
        return "one" if bool((t == 1).all()) else "not one"
    if not t.is_floating_point():
        return "zero" if not bool(t.any()) else "nonzero"
    rms = t.double().pow(2).mean().sqrt().item()
    return "zero" if rms == 0 else "0.02" if rms > 0.0045 else "1e-3"


def test_fill_rule_matches_jax_classes(monkeypatch):
    """Every leaf of the port's tiny model gets the scale class (0.02 x N
    for two or more dimensions, 1e-3 x N below, integers 0, `initted` 1)
    that `_fill_variables_f32` gives the JAX model's leaf it converts from.
    The JAX side draws ones in place of its normals, so each of its leaves
    holds its scale exactly (and the call compiles in seconds)."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.ones(shape, dtype))
    cfg = JaxTasteConfig.tiny()
    model = JaxTaste(cfg)
    d = {k: jnp.asarray(v) for k, v in inputs(cfg).items()}
    lm = {k: jnp.asarray(v) for k, v in lm_inputs(cfg).items()}
    shapes = jax.eval_shape(
        functools.partial(model.init, method=JaxTaste.init_all),
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), d["speaker_embeds"],
        d["asr_token_ids"], d["asr_token_lengths"], d["asr_word_ids"],
        d["audio_features"], jnp.zeros((2, 4), jnp.int32),
        jnp.full((2,), 4, jnp.int32), lm["llm_token_ids"],
        lm["llm_token_lengths"], lm["llm_word_ids"])
    filled = jax.tree.map(np.asarray,
                          _jax_script()._fill_variables_f32(dict(shapes)))
    want = convert.params_to_state_dict(filled)
    port = TasteForCausalLM(TasteConfig.tiny(), device="cpu")
    serving_fidelity.fill_f32(port, torch.Generator().manual_seed(0))
    got = port.state_dict()
    assert set(got) == set(want)
    wrong = {k: (_scale_class(k, got[k]), _scale_class(k, want[k]))
             for k in got if _scale_class(k, got[k]) != _scale_class(k, want[k])}
    assert not wrong
    classes = {_scale_class(k, v) for k, v in got.items()}
    assert {"0.02", "1e-3", "one"} <= classes


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_module_imports_nothing_of_jax():
    """Neither the module's own imports nor anything they load, in a fresh
    interpreter, is JAX or the JAX package."""
    def jaxish(name):
        return name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                      "taste_spokenlm_tpu")
    assert not [m for m in _imports(MODULE) if jaxish(m)]
    code = ("import sys; import taste_spokenlm_tpu_torch.scripts."
            "serving_fidelity; print(sorted({m.split('.')[0] for m in "
            "sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True).stdout
    loaded = ast.literal_eval(out.strip().splitlines()[-1])
    assert not [m for m in loaded if jaxish(m)]
