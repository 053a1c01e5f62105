"""The port's offline CLIs (taste_spokenlm_tpu_torch/scripts/
{create_seed_model,extract_vq,eval}.py), its profiling module
(utils/profiling.py) and its entry point (entry.py) against the JAX
package, at TasteConfig.tiny() on the CPU (`main(argv)` with --device
cpu); generate_audio and the real-data paths are in
tests/test_torch_clis_audio.py.

extract_vq's indices equal JAX's extract_vq on the same weights and
synthetic batches exactly; eval's metrics are JAX's within 1e-5; two seed
models are equal and --dtype bfloat16 rounds the same draws; the decode
byte counts are JAX's integers; entry()'s forward gives the JAX entry's
loss within 1e-5; every CLI raises without --device cpu on a host without
CUDA.  One worker: about 45 s.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taste_spokenlm_tpu.models.taste import TasteForCausalLM as JaxTaste
from taste_spokenlm_tpu_torch import convert, save_pretrained
from taste_spokenlm_tpu_torch.config import TasteConfig
from taste_spokenlm_tpu_torch.scripts import (create_seed_model, eval,
                                              extract_vq, generate_audio)

from torch_parity_common import (jit_apply, quantize_variables_jax,
                                 serving_config, tiny_pair)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


@pytest.fixture(scope="module")
def port_dir(pair, tmp_path_factory):
    """The tiny parity model (float, LoRA adapters) as a directory."""
    d = str(tmp_path_factory.mktemp("tiny_port"))
    save_pretrained(pair[3], d)
    return d


# ---------------------------------------------------------------------------
# extract_vq / eval / create_seed_model
# ---------------------------------------------------------------------------


def test_extract_vq_matches_jax(pair, port_dir, tmp_path):
    jcfg, jmodel, variables, _ = pair
    res = extract_vq.main(["--seed-model", port_dir, "--synthetic",
                           "--num-batches", "2", "--batch-size", "3",
                           "--output", str(tmp_path), "--device", "cpu"])
    with open(res["path"]) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == res["rows"] == 6
    keys = extract_vq.INPUTS
    i = 0
    for batch in extract_vq.synthetic_batches(TasteConfig.tiny(), 2, 3):
        asr_j, llm_j = jit_apply(jmodel, variables,
                                 *(jnp.asarray(batch[k]) for k in keys),
                                 method=JaxTaste.extract_vq)
        for bi in range(3):
            row = rows[i]
            assert row["asr_indices"] == np.asarray(asr_j)[bi].tolist()
            assert row["llm_indices"] == np.asarray(llm_j)[bi].tolist()
            assert row["llm_token_ids"] == batch["llm_token_ids"][bi].tolist()
            i += 1
    assert any(v >= 0 for r in rows for t in r["llm_indices"] for v in t)


def test_eval_matches_jax(pair, port_dir, tmp_path):
    from taste_spokenlm_tpu.ops.losses import masked_log_likelihood
    from taste_spokenlm_tpu.train.train_step import eval_metrics_stage2
    jcfg, jmodel, variables, _ = pair
    out = str(tmp_path / "eval.json")
    metrics = eval.main(["--seed-model", port_dir, "--synthetic",
                         "--num-batches", "1", "--batch-size", "2",
                         "--output", out, "--device", "cpu"])
    with open(out) as f:
        assert json.load(f) == metrics
    batch = {k: jnp.asarray(v) for k, v in next(eval.synthetic_batches(
        TasteConfig.tiny(), 1, 2, 0)).items()}
    s1 = jit_apply(jmodel, variables, *(batch[k] for k in (
        "speaker_embeds", "asr_token_ids", "asr_token_lengths", "asr_word_ids",
        "audio_features", "speech_token_ids", "speech_token_lengths")),
        method=JaxTaste.forward_speech_autoencoder)
    _, llm_idx = jit_apply(jmodel, variables, *(batch[k] for k in (
        "asr_token_ids", "asr_token_lengths", "asr_word_ids", "llm_token_ids",
        "llm_token_lengths", "llm_word_ids", "audio_features")),
        method=JaxTaste.extract_vq)
    o2 = jit_apply(jmodel, variables, llm_idx, batch["llm_token_ids"],
                   batch["llm_token_lengths"], batch["llm_word_ids"],
                   method=JaxTaste.forward_spoken_llm)
    want = {"loss": s1["loss"],
            "speech_token_accuracy": s1["speech_token_accuracy"],
            **eval_metrics_stage2(o2, jcfg.audio_tower.quantizer.num_quantizers)}
    want["loglikelihood"], want["reversed_loglikelihood"] = \
        masked_log_likelihood(o2["text_logits"], o2["text_labels"])
    assert set(metrics) == set(want)
    for k, v in want.items():
        v = float(v)
        assert abs(metrics[k] - round(v, 5)) <= 1e-5 * max(abs(v), 1.0), \
            (k, metrics[k], v)


def test_create_seed_model(tmp_path):
    """Seeded weights: two runs equal; --dtype bfloat16 (and --platform
    cpu) gives the same draws rounded to bf16 outside the f32 tower."""
    from taste_spokenlm_tpu_torch import from_pretrained
    for name in ("a", "b"):
        create_seed_model.main(["--tiny", "--device", "cpu", "--output",
                                str(tmp_path / name)])
    create_seed_model.main(["--tiny", "--platform", "cpu", "--dtype",
                            "bfloat16", "--output", str(tmp_path / "c")])
    a, _ = from_pretrained(str(tmp_path / "a"), device="cpu")
    b, _ = from_pretrained(str(tmp_path / "b"), device="cpu")
    c, _ = from_pretrained(str(tmp_path / "c"), device="cpu")
    sb, sc = b.state_dict(), c.state_dict()
    assert c.spoken_lm.language_model.norm.weight.dtype == torch.bfloat16
    for k, v in a.state_dict().items():
        assert torch.equal(v, sb[k]) and torch.isfinite(v.float()).all(), k
        assert torch.equal(v.to(sc[k].dtype), sc[k]), k
        if k.startswith("audio_tower."):
            assert sc[k].dtype == v.dtype, k


# ---------------------------------------------------------------------------
# profiling, entry, the device rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["float", "int8"])
def test_decode_step_bytes_match_jax(pair, layout):
    from taste_spokenlm_tpu.utils import profiling as jprof
    from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM
    from taste_spokenlm_tpu_torch.utils import profiling
    jcfg, _, variables, port = pair
    v = jax.tree.map(np.asarray, variables)
    pcfg = TasteConfig.tiny()
    if layout != "float":
        v = quantize_variables_jax(jcfg, v, layout)
        jcfg, pcfg = serving_config(jcfg, layout), serving_config(pcfg, layout)
        port = TasteForCausalLM(pcfg, device="cpu")
        port.load_state_dict(convert.to_torch(convert.params_to_state_dict(v)),
                             strict=True)
    for ctx in (1, 77):
        got = profiling.joint_decode_step_bytes(port.spoken_lm.state_dict(),
                                                pcfg, ctx)
        assert got == jprof.joint_decode_step_bytes(
            v["params"]["spoken_lm"], jcfg, ctx)
        got = profiling.s3_decode_step_bytes(port.speech_decoder.state_dict(),
                                             pcfg, ctx, kv_itemsize=4)
        assert got == jprof.s3_decode_step_bytes(
            v["params"]["speech_decoder"], jcfg, ctx, kv_itemsize=4)


def test_stage_timer_and_trace(tmp_path):
    """StageTimer's report, and each stage a tracer span of its name."""
    from taste_spokenlm_tpu_torch.utils import profiling
    from taste_spokenlm_tpu_torch.utils.profiling import StageTimer
    timer = StageTimer()
    profiling.reset()
    profiling.enable()
    try:
        for _ in range(2):
            with timer.stage("matmul", sync=torch.device("cpu")):
                torch.randn(64, 64) @ torch.randn(64, 64)
    finally:
        profiling.disable()
    spans = profiling.spans()
    profiling.reset()
    rep = timer.report(audio_seconds=2.0)
    assert timer.counts == {"matmul": 2} and rep["audio_s"] == 2.0
    assert rep["rtf"] == round(timer.stages["matmul"] / 2.0, 4)
    timer.dump(str(tmp_path / "t.json"), 2.0)
    with open(tmp_path / "t.json") as f:
        assert json.load(f) == rep
    assert [s.name for s in spans] == ["matmul", "matmul"]
    assert sum(s.end_ns - s.start_ns for s in spans) / 1e9 \
        >= timer.stages["matmul"]


def test_entry_matches_jax_entry(pair):
    """entry()'s batch is the JAX entry's (its _tiny_batch), and its fn on
    the parity model's weights gives the loss of the JAX entry's fn (the
    same forward_speech_autoencoder) on the same weights.  (JAX's entry()
    itself initializes its model eagerly, over a minute on the CPU.)"""
    from taste_spokenlm_tpu_torch.entry import BATCH_KEYS, entry
    spec = importlib.util.spec_from_file_location(
        "jax_graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    jentry = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jentry)
    jcfg, jmodel, variables, port = pair
    jbatch = jentry._tiny_batch(jcfg)
    out_j = jit_apply(jmodel, variables, *(jbatch[k] for k in BATCH_KEYS),
                      method=JaxTaste.forward_speech_autoencoder)
    fn, args = entry(device="cpu")
    model = args[0]
    assert len(args) == 1 + len(BATCH_KEYS)
    for got, k in zip(args[1:], BATCH_KEYS):
        np.testing.assert_array_equal(got.numpy(), np.asarray(jbatch[k]))
    loss, _ = fn(*args)
    assert torch.isfinite(loss)
    model.load_state_dict(port.state_dict(), strict=True)
    with torch.no_grad():
        loss, acc = fn(*args)
    np.testing.assert_allclose(float(loss), float(out_j["loss"]), rtol=1e-5)
    assert float(acc) == pytest.approx(float(out_j["speech_token_accuracy"]),
                                       abs=1e-6)


@pytest.mark.parametrize("cli", ["create_seed_model", "convert_checkpoint",
                                 "extract_vq", "generate_audio", "eval",
                                 "entry"])
def test_clis_without_cuda_raise(port_dir, tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from taste_spokenlm_tpu_torch.entry import entry
    from taste_spokenlm_tpu_torch.scripts import convert_checkpoint
    run = {
        "create_seed_model": lambda: create_seed_model.main(
            ["--tiny", "--output", str(tmp_path / "s")]),
        "convert_checkpoint": lambda: convert_checkpoint.main(
            ["--output", str(tmp_path / "c")]),
        "extract_vq": lambda: extract_vq.main(
            ["--seed-model", port_dir, "--synthetic", "--output",
             str(tmp_path)]),
        "generate_audio": lambda: generate_audio.main(
            ["--seed-model", port_dir, "--output-dir", str(tmp_path)]),
        "eval": lambda: eval.main(["--seed-model", port_dir, "--synthetic",
                                   "--output", str(tmp_path / "e.json")]),
        "entry": lambda: entry(),
    }[cli]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run()
