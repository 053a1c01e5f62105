"""The port's generation CLI (taste_spokenlm_tpu_torch/scripts/
generate_audio.py) and the real-data paths of extract_vq / eval against
the JAX package, at TasteConfig.tiny() on the CPU (`main(argv)` with
--device cpu).

generate_audio's greedy completion (a 44.1 kHz stereo wav through
load_audio, the processor and a CAM++-shaped x-vector graph; the offline
tokenizers) gives the llm tokens JAX's generate_completion gives on the
same inputs exactly, and its extract_vq JAX's indices; the synthetic
reconstruction and completion, the S3 topline from an S3-tokenizer-shaped
graph, the SpokenLLM reconstruction and a completion on the ASR's
transcript each write a finite wav; extract_vq over an arrow shard gives
JAX's indices on the same batches, and eval's selection scores are JAX's
logits read the same way.  One worker: about 40 s.
"""

import argparse
import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taste_spokenlm_tpu.models.sampler import SamplerConfig as JaxSamplerConfig
from taste_spokenlm_tpu.models.taste import TasteForCausalLM as JaxTaste
from taste_spokenlm_tpu_torch import save_pretrained
from taste_spokenlm_tpu_torch.config import TasteConfig
from taste_spokenlm_tpu_torch.frontend import onnx_build as B
from taste_spokenlm_tpu_torch.models.sampler import build_sampler_tables
from taste_spokenlm_tpu_torch.scripts import (_cli, eval, extract_vq,
                                              generate_audio)

from torch_parity_common import jit_apply, tiny_pair


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


@pytest.fixture(scope="module")
def port_dir(pair, tmp_path_factory):
    """The tiny parity model (float, LoRA adapters) as a directory."""
    d = str(tmp_path_factory.mktemp("tiny_port"))
    save_pretrained(pair[3], d)
    return d


def _wav(path, sr=44100, secs=1.2):
    t = np.arange(int(sr * secs)) / sr
    x = 0.3 * np.sin(2 * np.pi * 180 * t * (1 + 0.1 * np.sin(t)))
    pcm = (np.stack([x, 0.5 * x], 1).reshape(-1) * 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())
    return path


def _campplus(path, dim):
    """A CAM++-shaped x-vector graph: fbank [B, T, 80] -> conv + BN + ReLU
    -> mean / std pooling -> Gemm -> [B, dim]."""
    r = np.random.RandomState(5)
    c = 12
    init = {"w": (r.randn(c, 80, 3) * 0.2).astype(np.float32),
            "b": np.zeros(c, np.float32),
            "s": np.ones(c, np.float32), "bb": np.zeros(c, np.float32),
            "m": np.zeros(c, np.float32), "v": np.ones(c, np.float32),
            "e": (r.randn(2 * c, dim) * 0.2).astype(np.float32)}
    nodes = [B.node("Transpose", ["f"], ["ft"], perm=[0, 2, 1]),
             B.node("Conv", ["ft", "w", "b"], ["h"], kernel_shape=[3],
                    pads=[1, 1]),
             B.node("BatchNormalization", ["h", "s", "bb", "m", "v"], ["n"]),
             B.node("Relu", ["n"], ["r"]),
             B.node("ReduceMean", ["r"], ["mu"], axes=[2], keepdims=1),
             B.node("Sub", ["r", "mu"], ["cent"]),
             B.node("Mul", ["cent", "cent"], ["sq"]),
             B.node("ReduceMean", ["sq"], ["var"], axes=[2], keepdims=0),
             B.node("Sqrt", ["var"], ["sd"]),
             B.node("Squeeze", ["mu"], ["mu2"], axes=[2]),
             B.node("Concat", ["mu2", "sd"], ["stats"], axis=1),
             B.node("Gemm", ["stats", "e"], ["xvec"])]
    with open(path, "wb") as f:
        f.write(B.build(nodes, ["f"], ["xvec"], init))
    return path


def _s3_graph(path, n_mels, vocab):
    """An S3-tokenizer-shaped graph: (mel [1, n_mels, T], len) -> stride-2
    conv -> nearest codebook row (ArgMin) -> int32 ids."""
    r = np.random.RandomState(6)
    d = 8
    init = {"w": (r.randn(d, n_mels, 3) * 0.1).astype(np.float32),
            "cb": r.randn(vocab, d).astype(np.float32),
            "m2": np.asarray(-2.0, np.float32)}
    nodes = [B.node("Conv", ["mel", "w"], ["h"], kernel_shape=[3], strides=[2],
                    pads=[1, 1]),
             B.node("Transpose", ["h"], ["e"], perm=[0, 2, 1]),
             B.node("Transpose", ["cb"], ["cbt"], perm=[1, 0]),
             B.node("MatMul", ["e", "cbt"], ["ec"]),
             B.node("Mul", ["ec", "m2"], ["d1"]),
             B.node("Mul", ["cb", "cb"], ["c2"]),
             B.node("ReduceSum", ["c2"], ["cs"], axes=[-1], keepdims=0),
             B.node("Add", ["d1", "cs"], ["dist"]),
             B.node("ArgMin", ["dist"], ["ids"], axis=-1, keepdims=0),
             B.node("Cast", ["ids"], ["ids32"], to=6)]
    with open(path, "wb") as f:
        f.write(B.build(nodes, ["mel", "mel_len"], ["ids32"], init))
    return path


# ---------------------------------------------------------------------------
# generate_audio
# ---------------------------------------------------------------------------

GEN_ARGS = ["--task", "completion", "--text", "a seeded chirp for the test",
            "--asr-tokenizer", "offline", "--llm-tokenizer", "offline",
            "--text-top-p", "0", "--max-decode-steps", "16",
            "--max-speech-steps", "24", "--mel-len-max", "48", "--device", "cpu"]


def test_generate_audio_greedy_completion_matches_jax(pair, port_dir, tmp_path):
    jcfg, jmodel, variables, _ = pair
    wav = _wav(str(tmp_path / "in.wav"))
    onnx = _campplus(str(tmp_path / "campplus.onnx"),
                     jcfg.speech_decoder.spk_embed_dim)
    argv = ["--seed-model", port_dir, "--input-wav", wav, "--campplus-onnx",
            onnx, "--output-dir", str(tmp_path / "out")] + GEN_ARGS
    meta = generate_audio.main(argv)
    with open(tmp_path / "out" / "in.json") as f:
        assert json.load(f) == json.loads(json.dumps(meta))

    # the CLI's inputs, rebuilt as it builds them
    from taste_spokenlm_tpu_torch import from_pretrained
    from taste_spokenlm_tpu_torch.frontend.processor import (
        speaker_embedder_from_onnx)
    from taste_spokenlm_tpu_torch.utils.profiling import StageTimer
    p = generate_audio.parser()
    args = p.parse_args(argv)
    cfg = TasteConfig.tiny()
    asr_tok, llm_tok = _cli.load_tokenizers("offline", "offline", cfg)
    model, proc = from_pretrained(port_dir, llm_tokenizer=llm_tok,
                                  asr_tokenizer=asr_tok, device="cpu")
    proc.speaker_embedder = speaker_embedder_from_onnx(onnx, device="cpu")
    data = generate_audio.prepare(args, model, proc, asr_tok, llm_tok,
                                  StageTimer(), p)["inputs"]
    spk = data["speaker_embeds"]
    assert spk.shape == (1, 16) and abs(np.linalg.norm(spk) - 1) < 1e-5

    keys = ("asr_token_ids", "asr_token_lengths", "asr_word_ids",
            "llm_token_ids", "llm_token_lengths", "llm_word_ids",
            "audio_features")
    _, idx_j = jit_apply(jmodel, variables, *(jnp.asarray(data[k]) for k in keys),
                         method=JaxTaste.extract_vq)
    x = _cli.to_device(data, torch.device("cpu"), keys)
    _, idx_p = model.extract_vq(*(x[k] for k in keys))
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))

    tables = build_sampler_tables(llm_tok, cfg.spoken_lm.llama.vocab_size)
    scfg = JaxSamplerConfig(
        delay=jcfg.spoken_lm.delay, delay_level=jcfg.spoken_lm.delay_level,
        extra_words=8, text_top_p=0.0, taste_top_p=0.0, text_temperature=0.5,
        repetition_penalty=1.1, has_prefix=True)
    out_j = jax.jit(lambda v, *a: jmodel.apply(
        v, jax.random.PRNGKey(0), scfg,
        {k: jnp.asarray(t) for k, t in tables.items()}, *a, "audio", 16,
        method=JaxTaste.generate_completion))(
            variables, idx_j, jnp.asarray(data["llm_token_ids"]),
            jnp.asarray(data["llm_token_lengths"]),
            jnp.asarray(data["llm_word_ids"]))
    n = int(out_j["num_tokens"][0])
    assert n >= 2
    assert meta["generated_llm_token_ids"] == \
        np.asarray(out_j["llm_token_ids"])[0, :n].tolist()

    with wave.open(str(tmp_path / "out" / "in.wav")) as f:
        got = np.frombuffer(f.readframes(f.getnframes()), "<i2")
        assert f.getframerate() == cfg.hift.sampling_rate
    assert len(got) == meta["samples"] > 0
    assert len(meta["speech_token_ids"]) == meta["speech_tokens"] > 0
    assert set(meta["timing"]["stages"]) >= {"load_audio", "processor",
                                             "extract_vq", "completion"}


@pytest.mark.parametrize("task", ["reconstruction", "completion", "topline",
                                  "spokenllm", "asr"])
def test_generate_audio_other_paths_run(port_dir, tmp_path, task):
    """The synthetic reconstruction and completion (no wav, no tokenizer),
    the S3 topline on an S3-tokenizer-shaped graph over a wav, the
    SpokenLLM reconstruction, and a completion conditioned on the ASR's
    transcript (WhisperForASR over the tower, no --text): each writes a
    finite wav and its metadata."""
    cfg = TasteConfig.tiny()
    out = str(tmp_path / "out")
    common = ["--seed-model", port_dir, "--output-dir", out, "--device", "cpu",
              "--max-speech-steps", "16", "--mel-len-max", "32",
              "--max-decode-steps", "8"]
    argv = {
        "reconstruction": ["--task", "reconstruction"],
        "completion": ["--task", "completion", "--conditional-mode", "instruct"],
        "topline": ["--task", "reconstruction", "--use-target-speech-token",
                    "--input-wav", str(tmp_path / "w.wav"),
                    "--text", "two words", "--asr-tokenizer", "offline",
                    "--s3-onnx", _s3_graph(str(tmp_path / "s3.onnx"),
                                           cfg.audio_tower.whisper.n_mels,
                                           cfg.speech_decoder.speech_token_size)],
        "spokenllm": ["--task", "reconstruction", "--reconstruction-mode",
                      "SpokenLLM", "--input-wav", str(tmp_path / "w.wav"),
                      "--text", "three more words", "--asr-tokenizer",
                      "offline"],
        "asr": ["--task", "completion", "--input-wav", str(tmp_path / "w.wav"),
                "--asr-tokenizer", "offline", "--text-top-p", "0"],
    }[task]
    _wav(str(tmp_path / "w.wav"), *((24000, 0.5) if task == "topline"
                                    else (44100, 1.2)))
    meta = generate_audio.main(common + argv)
    assert meta["samples"] > 0 and meta["speech_tokens"] > 0
    stem = "w" if task in ("topline", "spokenllm", "asr") \
        else f"{meta['task']}_0"
    with wave.open(os.path.join(out, f"{stem}.wav")) as f:
        assert f.getnframes() == meta["samples"]
    if task == "topline":   # 0.5 s at 16 kHz: 50 mel frames, the stride 2
        assert meta["speech_tokens"] == 8000 // 160 // 2
    if task == "asr":       # the transcript is the tower's greedy decode
        from taste_spokenlm_tpu_torch import from_pretrained
        model, _ = from_pretrained(port_dir, device="cpu")
        asr_tok, _ = _cli.load_tokenizers("offline", None, cfg)
        text = generate_audio.make_transcriber(model, asr_tok)(
            generate_audio.load_audio(str(tmp_path / "w.wav"), 16000))
        assert meta["orig_text"] == (text or "[UNK]")
        assert "asr_transcribe" in meta["timing"]["stages"]


# ---------------------------------------------------------------------------
# the real-data paths of extract_vq and eval
# ---------------------------------------------------------------------------


def _arrow_shard(path):
    """Two utterances (16 and 24 kHz) as a stage-1 arrow shard."""
    datasets = pytest.importorskip("datasets")
    r = np.random.RandomState(0)
    rows = {"mp3": [], "json": [], "s3_token": [], "spk_emb": []}
    for i, (sr, secs) in enumerate(((16000, 0.9), (24000, 1.3))):
        t = np.arange(int(sr * secs)) / sr
        rows["mp3"].append({"array": (0.3 * np.sin(2 * np.pi * 200 * t)
                                      ).astype(np.float32),
                            "sampling_rate": sr})
        rows["json"].append({"text": " ".join(["one", "two", "three"][:2 + i])})
        rows["s3_token"].append(r.randint(0, 64, 20).tolist())
        rows["spk_emb"].append(r.randn(16).astype(np.float32))
    datasets.Dataset.from_dict(rows).save_to_disk(str(path))
    return str(path / "*.arrow")


def test_real_data_paths_match_jax(pair, port_dir, tmp_path):
    """extract_vq and eval over an arrow shard with the offline tokenizers
    (stage1_batches), and eval's --selection-data: the indices are JAX's
    extract_vq on the same batches, the selection scores JAX's
    forward_spoken_llm logits read the same way."""
    jcfg, jmodel, variables, _ = pair
    shard = _arrow_shard(tmp_path / "shard")
    data = ["--data", shard, "--asr-tokenizer", "offline", "--llm-tokenizer",
            "offline", "--num-batches", "0", "--device", "cpu"]
    res = extract_vq.main(["--seed-model", port_dir, "--output",
                           str(tmp_path / "vq")] + data)
    with open(res["path"]) as f:
        rows = [json.loads(line) for line in f]
    args = argparse.Namespace(
        data=[shard], asr_tokenizer="offline", llm_tokenizer="offline",
        num_batches=0, token_budget=2048)
    batches = list(_cli.stage1_batches(args, TasteConfig.tiny()))
    assert len(rows) == sum(b["llm_token_ids"].shape[0] for b in batches) == 2
    i = 0
    for b in batches:
        asr_j, llm_j = jit_apply(jmodel, variables, *(
            jnp.asarray(b[k]) for k in extract_vq.INPUTS),
            method=JaxTaste.extract_vq)
        for bi in range(b["llm_token_ids"].shape[0]):
            n = int(b["llm_token_lengths"][bi])
            assert rows[i]["asr_indices"] == np.asarray(asr_j)[bi].tolist()
            assert rows[i]["llm_indices"] == np.asarray(llm_j)[bi, :n].tolist()
            i += 1

    pairs = [{"prefix": [5, 6, 7], "real": [8, 9], "distractor": [10, 11, 12]},
             {"prefix": [20, 21], "real": [30], "distractor": [31, 32]}]
    sel = tmp_path / "pairs.jsonl"
    sel.write_text("".join(json.dumps(q) + "\n" for q in pairs))
    metrics = eval.main(["--seed-model", port_dir, "--output",
                         str(tmp_path / "e.json"), "--selection-data",
                         str(sel)] + data)
    assert np.isfinite(metrics["loss"]) and metrics["selection_pairs"] == 2
    n_levels, t = jcfg.audio_tower.quantizer.num_quantizers, 16

    def cont_ll(prefix, cont):
        ids = np.zeros((t,), np.int32)
        seq = prefix + cont
        ids[:len(seq)] = seq
        out = jit_apply(jmodel, variables, jnp.full((1, t, n_levels), -1),
                        jnp.asarray(ids)[None], jnp.asarray([len(seq)]),
                        jnp.arange(t)[None], method=JaxTaste.forward_spoken_llm)
        lg = np.asarray(out["text_logits"], np.float64)[0]
        lab = np.asarray(out["text_labels"])[0]
        lse = lg.max(-1) + np.log(np.exp(lg - lg.max(-1, keepdims=True)).sum(-1))
        keep = np.flatnonzero(lab != -1)[-len(cont):]
        return float((lg[keep, lab[keep]] - lse[keep]).mean())
    real = [cont_ll(q["prefix"], q["real"]) for q in pairs]
    dist = [cont_ll(q["prefix"], q["distractor"]) for q in pairs]
    assert metrics["selection_accuracy"] == np.mean(np.greater(real, dist))
    for key, want in (("selection_ll_real", np.mean(real)),
                      ("selection_ll_distractor", np.mean(dist))):
        assert abs(metrics[key] - round(want, 5)) <= 1e-5 * max(abs(want), 1)
