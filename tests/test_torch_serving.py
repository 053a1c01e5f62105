"""The port's serving layer (serving/server.py TasteEngine.complete /
complete_batch, CompleteBatcher, run_load_test, the gRPC and HTTP servers),
its checkpoints (pretrained.py) and its completion pipeline
(frontend/api.py) against the JAX package at TasteConfig.tiny(), float32
on the CPU, with the same weights through taste_spokenlm_tpu_torch.convert.

A sampled decode reads JAX's draws, computed with JAX from its keys: row i
of JAX's batched decode draws its step-s text and taste gumbel from
split(fold_in(_host_key(seed_i), s)); the pipeline's decode from its key's
split chain and its synthesis from the S3 and vocoder keys.  The port's
model receives them through a spy on its entry point, as the streaming
tests do for reconstruct.  Token ids, word ids, taste indices and counts
must be equal exactly, waveforms within 1e-3 absolute.
"""

import functools
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taste_spokenlm_tpu.frontend import api as jax_api
from taste_spokenlm_tpu.serving.server import TasteEngine as JaxEngine
from taste_spokenlm_tpu_torch import (from_pretrained, pretrained,
                                      save_pretrained)
from taste_spokenlm_tpu_torch.config import TasteConfig
from taste_spokenlm_tpu_torch.frontend import api
from taste_spokenlm_tpu_torch.serving.server import (CompleteBatcher,
                                                     TasteEngine,
                                                     create_grpc_server,
                                                     create_http_server,
                                                     run_load_test)

from taste_spokenlm_tpu_torch.models.sampler import build_sampler_tables

from torch_parity_common import (VocabScan, jd_draws_jax, port_model,
                                 quantize_variables_jax, s3_gumbel,
                                 serving_config, t, tiny_pair, voice_noise)

torch.set_num_threads(2)
GREEDY = dict(extra_words=2, text_top_p=0.0, taste_top_p=0.0,
              text_temperature=1.0, repetition_penalty=1.0)
# hot enough that the tiny model's text and taste depend on the draws
SAMPLED = dict(extra_words=2, text_top_p=0.95, taste_top_p=0.95,
               text_temperature=4.0, repetition_penalty=1.1)
STEPS = 8
KEYS = ("llm_token_ids", "llm_word_ids", "taste_indices", "num_tokens",
        "num_taste_words")


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


@pytest.fixture(scope="module")
def engines(pair):
    cfg, model, variables, port = pair
    return (JaxEngine(model, variables, cfg, token_buckets=(8, 16)),
            TasteEngine(port, port.config, token_buckets=(8, 16)))


def _mk_requests(cfg, n, seed0=0, seed=11):
    """tests/test_serving.py's requests: ragged prefixes of 4-6 tokens,
    two a word, taste indices at the even positions."""
    nq = cfg.audio_tower.quantizer.num_quantizers
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        ln = 4 + (i % 3)
        reqs.append(dict(
            llm_ids=rng.randint(2, 90, ln).tolist(),
            llm_word_ids=(np.arange(ln) // 2).tolist(),
            llm_indices=np.where(
                (np.arange(ln) % 2 == 0)[:, None],
                rng.randint(0, 4, (ln, nq)), -1).astype(np.int32),
            seed=seed0 + 3 * i))
    return reqs


def _solo(engine, r, kw, max_steps=STEPS):
    return engine.complete(r["llm_ids"], r["llm_word_ids"], r["llm_indices"],
                           kw, seed=r["seed"], max_steps=max_steps)


def assert_same_rows(got, ref, keys=KEYS):
    assert len(got) == len(ref) > 0
    for i, (g, r) in enumerate(zip(got, ref)):
        for k in keys:
            np.testing.assert_array_equal(g[k], np.asarray(r[k]),
                                          err_msg=f"row {i} {k}")


# ---------------------------------------------------------------------------
# complete / complete_batch
# ---------------------------------------------------------------------------


def test_complete_matches_jax_engine(pair, engines):
    jax_engine, engine = engines
    r = _mk_requests(pair[0], 1)[0]
    got = _solo(engine, r, GREEDY)
    assert_same_rows([got], [_solo(jax_engine, r, GREEDY)])
    assert 0 < int(got["num_tokens"]) <= STEPS
    assert got["ran"]["nb"] == 1 and got["ran"]["bucket"] == 8


def test_complete_batch_greedy_ragged_matches_jax_engine(pair, engines):
    jax_engine, engine = engines
    reqs = _mk_requests(pair[0], 3)
    got = engine.complete_batch(reqs, GREEDY, max_steps=STEPS)
    assert_same_rows(got, jax_engine.complete_batch(reqs, GREEDY,
                                                    max_steps=STEPS))
    assert all(int(g["num_tokens"]) > 0 for g in got)
    ran = got[0]["ran"]
    assert all(g["ran"] is ran for g in got)
    delay = pair[0].spoken_lm.delay
    assert (ran["nb"], ran["bucket"], ran["rows"]) == (4, 8, 3)
    assert ran["prefill_rows"] == 4 * (1 + 8 + delay)
    assert 0 < ran["steps"] <= STEPS


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _row_gumbel(keys, steps, v, l, k):
    """JAX's batched decode draws for a [B, 2] key batch: row i's text
    [steps, B, V] and taste [steps, B, L, K] gumbel at step s from
    split(fold_in(keys[i], s)), as jax.random.categorical draws them."""
    def draw(key, s):
        k_text, k_taste = jax.random.split(jax.random.fold_in(key, s))
        return (jax.random.gumbel(k_text, (v,), jnp.float32),
                jax.random.gumbel(k_taste, (l, k), jnp.float32))
    return jax.vmap(lambda s: jax.vmap(lambda key: draw(key, s))(keys))(
        jnp.arange(steps))


def _with_jax_row_draws(monkeypatch, engine, cfg, seeds_by_call):
    """Spy on the port model's generate_completion: each call gets the
    gumbel of JAX's per-row key chain for its rows' seeds (pad rows seed
    0, as JAX's engine pads), and the generators it was given are
    recorded."""
    real = engine.model.generate_completion
    q = cfg.audio_tower.quantizer
    calls = []

    def spy(scfg, tables, *args, generator, **kw):
        seeds = seeds_by_call[len(calls)]
        seeds = seeds + [0] * (len(generator) - len(seeds))
        keys = np.stack([JaxEngine._host_key(s) for s in seeds])
        text, taste = _row_gumbel(jnp.asarray(keys), args[5],
                                  cfg.spoken_lm.llama.vocab_size,
                                  q.num_quantizers, q.codebook_size)
        calls.append([g.initial_seed() for g in generator])
        return real(scfg, tables, *args, text_gumbel=t(text),
                    taste_gumbel=t(taste), **kw)
    monkeypatch.setattr(engine.model, "generate_completion", spy)
    return calls


def test_complete_batch_sampled_matches_jax_on_its_row_draws(
        monkeypatch, pair, engines):
    """A sampled cohort, one seed past 2**63, on JAX's per-row draws:
    JAX's engine's rows exactly; each row's generator seeded with its
    request's seed."""
    cfg = pair[0]
    jax_engine, engine = engines
    reqs = _mk_requests(cfg, 3, seed0=5)
    reqs[1]["seed"] = 2 ** 63 + 12345
    seeds = [r["seed"] for r in reqs]
    calls = _with_jax_row_draws(monkeypatch, engine, cfg, [seeds])
    got = engine.complete_batch(reqs, SAMPLED, max_steps=STEPS)
    assert_same_rows(got, jax_engine.complete_batch(reqs, SAMPLED,
                                                    max_steps=STEPS))
    assert calls == [seeds + [0]]


def test_batched_row_equals_its_solo_run(pair, engines):
    """A sampled request's output does not depend on its cohort: each row
    of a batch, and the same requests batched in another order, equal
    their solo runs exactly (per-row generators)."""
    _, engine = engines
    reqs = _mk_requests(pair[0], 3, seed0=5)
    batched = engine.complete_batch(reqs, SAMPLED, max_steps=STEPS)
    solo = [_solo(engine, r, SAMPLED) for r in reqs]
    assert_same_rows(batched, solo)
    assert_same_rows(engine.complete_batch(reqs[::-1], SAMPLED,
                                           max_steps=STEPS), solo[::-1])
    # and the draws matter: four seeds give more than one trajectory
    assert len({tuple(_solo(engine, dict(reqs[2], seed=s), SAMPLED)
                      ["llm_token_ids"]) for s in range(4)}) > 1


@pytest.mark.parametrize("seed", [2 ** 63, 2 ** 63 + 12345, 2 ** 64 - 1])
def test_seeds_at_and_above_2_63(pair, engines, seed):
    """uint64 seeds past int64 seed a generator each (no overflow), the
    same seed gives the same output, and seeds that differ only in the
    high word differ."""
    _, engine = engines
    r = dict(_mk_requests(pair[0], 1)[0], seed=seed)
    a, b = _solo(engine, r, SAMPLED), _solo(engine, r, SAMPLED)
    assert_same_rows([a], [b])
    assert engine._generator(seed).initial_seed() == seed
    assert engine._generator(seed).initial_seed() != \
        engine._generator(seed - 2 ** 63).initial_seed()


def test_complete_batch_chunks_oversized_cohorts(pair, engines):
    """18 requests decode as a 16-row call and a 2-row call; every row,
    the tail's too, equals its solo run."""
    _, engine = engines
    reqs = _mk_requests(pair[0], 18)
    res = engine.complete_batch(reqs, GREEDY, max_steps=4)
    assert len(res) == 18
    assert [res[0]["ran"]["nb"], res[17]["ran"]["nb"]] == [16, 2]
    assert len({r["ran"]["call"] for r in res}) == 2
    for i in (0, 15, 16, 17):
        assert_same_rows([res[i]], [_solo(engine, reqs[i], GREEDY, 4)])
        assert 0 < int(res[i]["num_tokens"]) <= 4


def test_complete_batcher_micro_batches(pair, engines):
    """Concurrent submissions with one config share one batched decode;
    each row equals its solo run; close() stops the loop thread."""
    _, engine = engines
    reqs = _mk_requests(pair[0], 3, seed0=2)
    batcher = CompleteBatcher(engine, max_batch=4, window_ms=200.0)
    try:
        futs = [batcher.submit(r["llm_ids"], r["llm_word_ids"],
                               r["llm_indices"], SAMPLED, seed=r["seed"],
                               max_steps=STEPS) for r in reqs]
        results = [f.result(timeout=120) for f in futs]
    finally:
        batcher.close()
    assert not batcher._thread.is_alive()
    assert len({r["ran"]["call"] for r in results}) == 1
    assert results[0]["ran"]["rows"] == 3
    assert_same_rows(results, [_solo(engine, r, SAMPLED) for r in reqs])


def test_complete_batcher_passes_errors_to_every_future(pair, engines):
    _, engine = engines
    r = _mk_requests(pair[0], 1)[0]
    batcher = CompleteBatcher(engine, max_batch=2, window_ms=50.0)
    try:
        futs = [batcher.submit(r["llm_ids"], r["llm_word_ids"],
                               r["llm_indices"], dict(GREEDY, bogus=1), seed=0)
                for _ in range(2)]
        for f in futs:
            with pytest.raises(TypeError, match="bogus"):
                f.result(timeout=60)
    finally:
        batcher.close()
    assert not batcher._thread.is_alive()


def test_run_load_test(pair, engines):
    """16 concurrent requests through the micro-batcher: JAX's keys, the
    latencies ordered, every result its complete_batch row."""
    _, engine = engines
    reqs = _mk_requests(pair[0], 16)
    stats = run_load_test(engine, reqs, SAMPLED, max_steps=6, max_batch=16,
                          window_ms=200.0)
    assert set(stats) == {"n", "p50_ms", "p99_ms", "max_ms", "wall_s",
                          "total_tokens", "tokens_per_sec", "results"}
    assert stats["n"] == 16
    assert 0 < stats["p50_ms"] <= stats["p99_ms"] <= stats["max_ms"]
    assert stats["total_tokens"] == sum(int(r["num_tokens"])
                                        for r in stats["results"]) > 0
    assert stats["tokens_per_sec"] > 0
    assert_same_rows(stats["results"],
                     engine.complete_batch(reqs, SAMPLED, max_steps=6))


# ---------------------------------------------------------------------------
# gRPC and HTTP
# ---------------------------------------------------------------------------


def _mel(cfg, seed=1):
    w = cfg.audio_tower.whisper
    return np.random.RandomState(seed).randn(
        w.n_mels, 2 * w.max_source_positions).astype(np.float32)


@pytest.fixture(scope="module")
def served(pair):
    """The engine behind the servers, with a deployment's sampler tables
    (the default ones start no word on these weights)."""
    cfg, _, _, port = pair
    engine = TasteEngine(port, port.config, token_buckets=(8, 16))
    engine._tables = {k: torch.from_numpy(v) for k, v in build_sampler_tables(
        VocabScan(), cfg.spoken_lm.llama.vocab_size).items()}
    return engine


@pytest.fixture(scope="module")
def grpc_channel(served):
    grpc = pytest.importorskip("grpc")
    engine = served
    server, port = create_grpc_server(engine, port=0)
    server.start()
    channel = grpc.insecure_channel(f"localhost:{port}")
    try:
        yield channel
    finally:
        channel.close()
        server.stop(0).wait(timeout=10)


def _rpc(channel, name, req_cls, resp_cls, stream=False):
    make = channel.unary_stream if stream else channel.unary_unary
    return make(f"/taste_serving.Taste/{name}",
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString)


def _pcm(wav):
    return (np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes()


def _tokenize_request(pb, cfg):
    mel = _mel(cfg)
    return pb.TokenizeRequest(
        audio_features=mel.reshape(-1).tolist(), n_mels=mel.shape[0],
        n_frames=mel.shape[1], asr_token_ids=list(range(10, 18)),
        asr_word_ids=[0, 0, 1, 1, 2, 2, 3, 3]), mel


def test_grpc_tokenize_and_reconstruct_equal_the_engine(pair, served,
                                                        grpc_channel):
    from taste_spokenlm_tpu_torch.serving import taste_serving_pb2 as pb
    cfg = pair[0]
    engine = served
    req, mel = _tokenize_request(pb, cfg)
    resp = _rpc(grpc_channel, "Tokenize", pb.TokenizeRequest,
                pb.TokenizeResponse)(req, timeout=120)
    idx = engine.tokenize(mel, list(req.asr_token_ids), list(req.asr_word_ids))
    assert resp.n_quantizers == cfg.audio_tower.quantizer.num_quantizers
    assert list(resp.indices) == idx.reshape(-1).tolist()

    spk = [0.1] * cfg.speech_decoder.spk_embed_dim
    r2 = _rpc(grpc_channel, "Reconstruct", pb.ReconstructRequest,
              pb.ReconstructResponse)(pb.ReconstructRequest(
                  inputs=req, speaker_embedding=spk, max_speech_steps=8,
                  seed=3), timeout=120)
    wav, sr, n_tok, _ = engine.reconstruct(
        mel, list(req.asr_token_ids), list(req.asr_word_ids),
        np.asarray(spk, np.float32), 8, 3)
    assert (r2.sample_rate, r2.num_speech_tokens) == (sr, n_tok)
    assert r2.pcm16 == _pcm(wav) and len(r2.pcm16) > 0 and r2.rtf > 0


def test_grpc_complete_equals_the_engine(pair, served, grpc_channel):
    from taste_spokenlm_tpu_torch.serving import taste_serving_pb2 as pb
    cfg = pair[0]
    engine = served
    r = _mk_requests(cfg, 1, seed0=9)[0]
    resp = _rpc(grpc_channel, "Complete", pb.CompleteRequest,
                pb.CompleteResponse)(pb.CompleteRequest(
                    llm_token_ids=r["llm_ids"], llm_word_ids=r["llm_word_ids"],
                    llm_indices=r["llm_indices"].reshape(-1).tolist(),
                    extra_words=2, text_top_p=0.95, taste_top_p=0.95,
                    temperature=4.0, repetition_penalty=1.1,
                    seed=2 ** 63 + 1), timeout=120)
    # the RPC's float32 fields and its default max_steps, 128
    want = engine.complete(r["llm_ids"], r["llm_word_ids"], r["llm_indices"],
                           {k: float(np.float32(v)) if isinstance(v, float)
                            else v for k, v in SAMPLED.items()},
                           seed=2 ** 63 + 1)
    n, nt = int(want["num_tokens"]), int(want["num_taste_words"])
    assert n > 0
    assert list(resp.token_ids) == want["llm_token_ids"][:n].tolist()
    assert list(resp.word_ids) == want["llm_word_ids"][:n].tolist()
    assert list(resp.taste_indices) == \
        want["taste_indices"][:nt].reshape(-1).tolist()
    assert resp.num_taste_words == nt


def test_grpc_synthesize_equals_the_engine(pair, served, grpc_channel):
    from taste_spokenlm_tpu_torch.serving import taste_serving_pb2 as pb
    cfg = pair[0]
    engine = served
    nq = cfg.audio_tower.quantizer.num_quantizers
    rng = np.random.RandomState(3)
    taste = rng.randint(0, cfg.audio_tower.quantizer.codebook_size,
                        (4, nq)).astype(np.int32)
    asr_ids = rng.randint(5, 100, 8).tolist()
    asr_words = np.minimum(np.arange(8) // 2, 3).tolist()
    spk = (0.1 * np.ones(cfg.speech_decoder.spk_embed_dim)).tolist()
    chunks = list(_rpc(grpc_channel, "Synthesize", pb.SynthesizeRequest,
                       pb.SynthesizeChunk, stream=True)(pb.SynthesizeRequest(
                           taste_indices=taste.reshape(-1).tolist(),
                           n_words=4, asr_token_ids=asr_ids,
                           asr_word_ids=asr_words, speaker_embedding=spk,
                           max_speech_steps=16, chunk_tokens=5, seed=11),
                           timeout=120))
    want = list(engine.synthesize_stream(taste, asr_ids, asr_words,
                                         np.asarray(spk, np.float32),
                                         max_steps=16, chunk_tokens=5,
                                         seed=11))
    assert len(chunks) == len(want) > 0 and chunks[-1].is_last
    for c, (wav, last, n_new) in zip(chunks, want):
        assert (c.pcm16, c.is_last, c.num_tokens) == (_pcm(wav), last, n_new)
        assert c.sample_rate == cfg.hift.sampling_rate


def test_grpc_complete_stream_equals_the_engine(pair, served, grpc_channel):
    from taste_spokenlm_tpu_torch.serving import taste_serving_pb2 as pb
    cfg = pair[0]
    engine = served
    nq = cfg.audio_tower.quantizer.num_quantizers
    rng = np.random.RandomState(5)
    word_ids = (np.arange(7) // 2).tolist()
    idx = np.full((7, nq), -1, np.int32)
    starts = np.flatnonzero(np.diff(word_ids, prepend=-1) != 0)
    idx[starts] = rng.randint(0, cfg.audio_tower.quantizer.codebook_size,
                              (len(starts), nq))
    llm_ids = rng.randint(2, cfg.spoken_lm.llama.vocab_size, 7).tolist()
    asr_ids = rng.randint(5, 100, 8).tolist()
    asr_words = np.minimum(np.arange(8) // 2, 5).tolist()
    spk = (0.1 * np.ones(cfg.speech_decoder.spk_embed_dim)).tolist()
    req = pb.CompleteStreamRequest(
        complete=pb.CompleteRequest(
            llm_token_ids=llm_ids, llm_word_ids=word_ids,
            llm_indices=idx.reshape(-1).tolist(), extra_words=16,
            text_top_p=0.95, taste_top_p=0.95, temperature=4.0, seed=7),
        asr_token_ids=asr_ids, asr_word_ids=asr_words,
        speaker_embedding=spk, max_speech_steps=12, chunk_tokens=5,
        first_chunk_tokens=2, jd_first_chunk=3, max_steps=16)
    chunks = list(_rpc(grpc_channel, "CompleteStream",
                       pb.CompleteStreamRequest, pb.SynthesizeChunk,
                       stream=True)(req, timeout=300))
    want = list(engine.complete_stream(
        llm_ids, word_ids, idx, asr_ids, asr_words,
        np.asarray(spk, np.float32),
        dict(extra_words=16, text_top_p=float(np.float32(0.95)),
             taste_top_p=float(np.float32(0.95)), text_temperature=4.0,
             repetition_penalty=1.0), 7,
        max_steps=16, max_speech_steps=12, chunk_tokens=5,
        first_chunk_tokens=2, jd_first_chunk=3))
    assert len(chunks) == len(want) > 0 and chunks[-1].is_last
    for c, (wav, last, n_new, n_words) in zip(chunks, want):
        assert (c.pcm16, c.is_last, c.num_tokens, c.n_words) == (
            _pcm(wav), last, n_new, n_words)


@pytest.fixture(scope="module")
def http_url(served):
    engine = served
    server = create_http_server(engine, port=0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def test_http_health_tokenize_and_reconstruct(pair, served, http_url):
    import base64
    cfg = pair[0]
    engine = served
    with urllib.request.urlopen(f"{http_url}/health", timeout=30) as r:
        assert json.load(r) == {"status": "ok"}
    mel = _mel(cfg)
    ids, words = list(range(10, 18)), [0, 0, 1, 1, 2, 2, 3, 3]
    out = _post(f"{http_url}/tokenize", {"audio_features": mel.tolist(),
                                         "asr_token_ids": ids,
                                         "asr_word_ids": words})
    np.testing.assert_array_equal(out["indices"],
                                  engine.tokenize(mel, ids, words))
    spk = np.full(cfg.speech_decoder.spk_embed_dim, 0.1, np.float32)
    out = _post(f"{http_url}/reconstruct", {
        "audio_features": mel.tolist(), "asr_token_ids": ids,
        "asr_word_ids": words, "speaker_embedding": spk.tolist(),
        "max_speech_steps": 8, "seed": 3})
    wav, sr, n_tok, _ = engine.reconstruct(mel, ids, words, spk, 8, 3)
    assert base64.b64decode(out["pcm16_b64"]) == _pcm(wav)
    assert (out["sample_rate"], out["num_speech_tokens"]) == (sr, n_tok)


@pytest.mark.parametrize("method,path,body,code", [
    ("GET", "/nope", None, 404), ("POST", "/nope", {}, 404),
    ("POST", "/tokenize", {"audio_features": [[0.0]]}, 500)])
def test_http_errors(http_url, method, path, body, code):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"{http_url}{path}", data=data,
                                 method=method)
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=30)
    assert err.value.code == code
    assert "error" in json.load(err.value)


def test_server_imports_without_grpc():
    """serving.server needs neither grpc nor protobuf to import."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['grpc'] = None; "
            "sys.modules['google.protobuf'] = None; "
            "import taste_spokenlm_tpu_torch.serving.server as s; "
            "assert 'taste_spokenlm_tpu_torch.serving.taste_serving_pb2' "
            "not in sys.modules; print(s.TasteEngine.BATCH_BUCKETS)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "(1, 2, 4, 8, 16)"


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


def test_from_pretrained_round_trips_a_float_dir(tmp_path, pair):
    _, _, _, port = pair
    save_pretrained(port, str(tmp_path))
    model, proc = from_pretrained(str(tmp_path), device="cpu",
                                  asr_tokenizer=_ToyAsrTokenizer(),
                                  llm_tokenizer=_ToyLlmTokenizer())
    assert model.config.to_json() == port.config.to_json()
    assert pretrained.load_config(str(tmp_path)).to_json() == \
        port.config.to_json()
    _assert_same_state(model, port)
    assert not model.training and proc.device.type == "cpu"
    assert proc.process_text("hello there world")["llm_token_ids"].shape[0] == 1
    engine = TasteEngine.from_pretrained(str(tmp_path), token_buckets=(8, 16),
                                         device="cpu")
    _assert_same_state(engine.model, port)


def test_from_pretrained_keeps_the_saved_dtypes(tmp_path, pair):
    """A bf16 model with an f32 audio tower (the serving models' dtypes)
    loads with no dtype argument at the dtypes it was saved in, every
    tensor equal, through both entry points; an explicit dtype builds the
    whole model at it, the weights cast."""
    from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM
    port = pair[3]
    mixed = TasteForCausalLM(port.config, dtype=torch.bfloat16,
                             tower_dtype=torch.float32, device="cpu")
    mixed.load_state_dict(port.state_dict(), strict=True)
    save_pretrained(mixed, str(tmp_path))
    model, _ = from_pretrained(str(tmp_path), device="cpu")
    _assert_same_state(model, mixed)
    engine = TasteEngine.from_pretrained(str(tmp_path), token_buckets=(8,),
                                         device="cpu")
    _assert_same_state(engine.model, mixed)
    assert pretrained.saved_dtypes(mixed.state_dict()) == (torch.bfloat16,
                                                           torch.float32)
    f32, _ = from_pretrained(str(tmp_path), device="cpu", dtype=torch.float32)
    want = mixed.state_dict()
    got = f32.state_dict()
    assert got.keys() == want.keys()
    for k, v in got.items():
        if want[k].is_floating_point():
            assert v.dtype == torch.float32, k
        assert torch.equal(v, want[k].to(v.dtype)), k


def test_front_end_entry_points_raise_without_cuda(monkeypatch, tmp_path,
                                                  pair):
    """from_pretrained, TasteEngine.from_pretrained and TasteProcessor run
    on CUDA unless asked for the CPU, and raise without it."""
    from taste_spokenlm_tpu_torch.frontend.processor import TasteProcessor
    save_pretrained(pair[3], str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: from_pretrained(str(tmp_path)),
                 lambda: TasteEngine.from_pretrained(str(tmp_path)),
                 TasteProcessor):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert TasteProcessor(device="cpu").device.type == "cpu"


def test_from_pretrained_loads_an_int8_fused_serving_dir_strictly(tmp_path,
                                                                  pair):
    """A dir in the merged, int8, fused-qkv / fused-MLP serving layout (the
    JAX quantizer's weights, as test_api.py's fused dir) loads with
    strict=True and decodes as the model it was saved from; a config that
    does not describe the weights fails to load."""
    cfg, _, variables, _ = pair
    served = port_model(serving_config(TasteConfig.tiny(), "int8", True),
                        quantize_variables_jax(
                            serving_config(cfg, "int8", True),
                            jax.tree.map(np.asarray, variables), "int8",
                            True))
    save_pretrained(served, str(tmp_path))
    model, _ = from_pretrained(str(tmp_path), device="cpu")
    assert model.config.spoken_lm.llama.fused_qkv_serving
    _assert_same_state(model, served)
    reqs = _mk_requests(cfg, 2)
    assert_same_rows(
        TasteEngine(model, model.config, (8,)).complete_batch(reqs, GREEDY, 4),
        TasteEngine(served, served.config, (8,)).complete_batch(reqs, GREEDY,
                                                                4))
    with pytest.raises(RuntimeError, match="Missing key|Unexpected key"):
        from_pretrained(str(tmp_path), device="cpu", config_overrides=dict(
            spoken_lm=TasteConfig.tiny().spoken_lm))


# ---------------------------------------------------------------------------
# the completion pipeline
# ---------------------------------------------------------------------------


class _ToyLlmTokenizer:
    """tests/test_api.py's: id i decodes to ' w<i>' when i % 3 == 0 (a
    word start), else 'c<i>'."""

    def decode(self, ids):
        if isinstance(ids, (int, np.integer)):
            ids = [ids]
        return "".join((" w%d" % i) if i % 3 == 0 else ("c%d" % i)
                       for i in ids)

    def encode(self, word, add_special_tokens=False):
        return [(hash(word) % 100) + 2]


class _ToyAsrTokenizer:
    def encode(self, word, add_special_tokens=False):
        h = hash(word) % 500
        return [h, (h + 7) % 500]


PIPE = dict(max_decode_steps=32, max_asr_tokens=32, max_words=16,
            max_speech_steps=8, mel_len_max=16)


class _JittedApply:
    """A JAX model whose `apply` is jitted for each distinct set of static
    arguments (sampler config, mode, step counts: what is not an array):
    JAX's pipeline calls apply eagerly, which costs far more than a
    compile."""

    def __init__(self, model):
        self.model, self.config = model, model.config
        self._fns = {}

    def apply(self, variables, *args, method, **kw):
        is_array = [isinstance(a, (jax.Array, np.ndarray, dict)) for a in args]
        key = (method, tuple(a for a, arr in zip(args, is_array) if not arr),
               tuple(sorted(kw.items())))
        if key not in self._fns:
            def fn(v, *arrays):
                it = iter(arrays)
                full = [next(it) if arr else a
                        for a, arr in zip(args, is_array)]
                return self.model.apply(v, *full, method=method, **kw)
            self._fns[key] = jax.jit(fn)
        return self._fns[key](variables, *[a for a, arr in zip(args, is_array)
                                           if arr])


@pytest.fixture(scope="module")
def pipelines(pair):
    cfg, model, variables, port = pair
    toks = (_ToyLlmTokenizer(), _ToyAsrTokenizer())
    return (jax_api.CompletionPipeline(_JittedApply(model), variables, *toks,
                                       **PIPE),
            api.CompletionPipeline(port, *toks, **PIPE))


def _pipeline_request(cfg, seed=1):
    rng = np.random.RandomState(seed)
    t_ = 7
    return dict(
        speaker_embeds=rng.randn(1, cfg.speech_decoder.spk_embed_dim
                                 ).astype(np.float32),
        llm_token_ids=rng.randint(2, 100, (1, t_)).astype(np.int32),
        llm_word_ids=(np.arange(t_) // 2)[None].astype(np.int32),
        llm_indices=np.where(
            ((np.arange(t_) % 2) == 0)[None, :, None],
            rng.randint(0, cfg.audio_tower.quantizer.codebook_size,
                        (1, t_, cfg.audio_tower.quantizer.num_quantizers)),
            -1).astype(np.int32),
        asr_token_ids=rng.randint(5, 100, (1, 9)).astype(np.int32),
        asr_word_ids=np.minimum(np.arange(9) // 2, 3)[None].astype(np.int32))


def _pipeline_draws(cfg, seed):
    """The port pipeline's `draws` for JAX's PRNGKey(seed) decode and
    PRNGKey(seed + 1) synthesis."""
    k_dec, k_voc = jax.random.split(jax.random.PRNGKey(seed + 1))
    z, phase, noise = voice_noise(k_voc, 1, PIPE["mel_len_max"], cfg)
    return {**jd_draws_jax(cfg, jax.random.PRNGKey(seed),
                           PIPE["max_decode_steps"]),
            "gumbel": s3_gumbel(cfg, k_dec, PIPE["max_speech_steps"]),
            "z": t(z), "source_phase": t(phase), "source_noise": t(noise)}


def test_completion_pipeline_matches_jax_on_its_draws(monkeypatch, pair,
                                                      pipelines):
    cfg = pair[0]
    jax_pipe, pipe = pipelines
    req = _pipeline_request(cfg)
    ref = jax_pipe(**req, extra_words=2, seed=4)
    got = pipe(**req, extra_words=2, seed=4, draws=_pipeline_draws(cfg, 4))
    assert got.keys() == ref.keys()
    assert got["generated_text"] == ref["generated_text"] != ""
    for k in ("generated_llm_token_ids", "generated_word_ids",
              "generated_taste", "speech_token_ids", "speech_token_lengths",
              "waveform_lengths"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["waveform"].shape == ref["waveform"].shape
    assert np.isfinite(got["waveform"]).all()
    assert np.max(np.abs(got["waveform"] - ref["waveform"])) <= 1e-3
    # with its own generators the port runs the same request end to end:
    # the decode's seeded `seed`, the synthesis's `seed + 1`
    seeds = {}
    for name in ("generate_completion", "synthesize_from_taste"):
        def record(*a, _real=getattr(pipe.model, name), _name=name, **kw):
            seeds[_name] = kw["generator"].initial_seed()
            return _real(*a, **kw)
        monkeypatch.setattr(pipe.model, name, record)
    own = pipe(**req, extra_words=2, seed=4)
    assert seeds == {"generate_completion": 4, "synthesize_from_taste": 5}
    assert np.isfinite(own["waveform"]).all() and own["generated_text"]


def test_completion_text_only_matches_jax(pair, pipelines):
    cfg = pair[0]
    jax_pipe, pipe = pipelines
    rng = np.random.RandomState(2)
    req = dict(speaker_embeds=rng.randn(1, cfg.speech_decoder.spk_embed_dim
                                        ).astype(np.float32),
               llm_token_ids=rng.randint(2, 100, (1, 7)).astype(np.int32),
               llm_word_ids=(np.arange(7) // 2)[None].astype(np.int32),
               llm_indices=np.full((1, 7, 4), -1, np.int32),
               conditional_mode="text", output_text_only=True, extra_words=2)
    ref = jax_pipe(**req, seed=6)
    draws = jd_draws_jax(cfg, jax.random.PRNGKey(6), PIPE["max_decode_steps"])
    got = pipe(**req, seed=6, draws=draws)
    assert set(got) == {"generated_text"}
    assert got == ref


class _ChatTokenizer:
    eos_token_id = 9
    bos_token_id = 1

    def __init__(self, template: bool):
        self.template = template

    def apply_chat_template(self, msgs, tokenize, add_generation_prompt):
        if not self.template:
            raise ValueError("no chat template")
        return "".join(f"<{m['role']}>{m['content']}</s>" for m in msgs) \
            + "<assistant>"

    def encode(self, text, add_special_tokens=False):
        return [ord(c) % 50 + 2 for c in text]


@pytest.mark.parametrize("template", [True, False])
@pytest.mark.parametrize("system_prompt", [None, "be brief"])
def test_build_instruct_ids_matches_jax(template, system_prompt):
    tok = _ChatTokenizer(template)
    got = api.build_instruct_ids(tok, system_prompt)
    ref = jax_api.build_instruct_ids(tok, system_prompt)
    for g, r in zip(got[:2], ref[:2]):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    assert got[2] == ref[2] == 9
