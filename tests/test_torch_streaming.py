"""The port's streaming (models/taste.py stream_* / completion_*,
speech_decoder.generate_stream_resume, frontend/streaming.py and the
streaming core of serving/server.py TasteEngine) against the JAX package
at TasteConfig.tiny(), float32 on the CPU, with the same weights through
taste_spokenlm_tpu_torch.convert.

The port reads JAX's draws, computed with JAX from its key chains: the S3
gumbel of decode step s from the s-th split of the decode key
(`split(k)[1]`, the chain carried by `split(k)[0]`), the voice noise of
vocoder window k from fold_in(fold_in(synthesis key, 7919), k)
(torch_parity_common.voice_noise).  The joint decode runs greedy.  Token
trajectories, n_new, n_words and jd_done must be equal exactly, the wav
chunks within 1e-3 absolute (the sine source's f32 phase cumsum runs in
another summation order), and the seams continuous by the bound of
tests/test_streaming.py.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taste_spokenlm_tpu.frontend import streaming as jax_streaming
from taste_spokenlm_tpu.models.sampler import SamplerConfig as JaxSamplerConfig
from taste_spokenlm_tpu.models.sampler import build_sampler_tables
from taste_spokenlm_tpu.models.taste import TasteForCausalLM as JaxTaste
from taste_spokenlm_tpu.serving.server import TasteEngine as JaxEngine
from taste_spokenlm_tpu_torch.config import TasteConfig
from taste_spokenlm_tpu_torch.frontend import streaming
from taste_spokenlm_tpu_torch.kernels import fused_mlp
from taste_spokenlm_tpu_torch.models.sampler import SamplerConfig
from taste_spokenlm_tpu_torch.serving.server import TasteEngine

from torch_parity_common import (VocabScan, jd_draws_jax, lm_inputs,
                                 port_model, quantize_variables_jax,
                                 s3_gumbel, serving_config, t, tiny_pair,
                                 voice_noise)

torch.set_num_threads(2)
MAX_SPEECH, MEL_LEN_MAX = 16, 40
GEOM = dict(chunk_tokens=5, left_ctx_tokens=3, crossfade_tokens=1)
PIPE = dict(GEOM, first_chunk_tokens=2, max_speech_steps=12)
JD_STEPS = 10


def jax_draws(cfg, rng_syn, max_steps, b=1):
    """The port's `draws` for a JAX stream whose synthesis key is
    `rng_syn` (stream_synth_init splits it; the vocoder folds it)."""
    rng_voc = jax.random.fold_in(rng_syn, 7919)

    def voice(k, mel_window):
        return tuple(map(t, voice_noise(jax.random.fold_in(rng_voc, k), b,
                                        mel_window, cfg)))
    return {"s3_gumbel": s3_gumbel(cfg, jax.random.split(rng_syn)[0],
                                   max_steps, b), "voice": voice}


def cat(chunks, key="wav"):
    return np.concatenate([c[key] for c in chunks], axis=1)


def assert_same_chunks(got, ref, keys=("n_new", "is_last")):
    assert len(got) == len(ref) > 0
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(g["tokens"], np.asarray(r["tokens"]),
                                      err_msg=f"chunk {i}")
        for k in keys:
            assert g[k] == r[k], (i, k, g[k], r[k])
        assert g["wav"].shape == r["wav"].shape, i
        assert np.max(np.abs(g["wav"] - r["wav"]), initial=0.0) <= 1e-3, i


def assert_seams_continuous(chunks):
    """tests/test_streaming.py's bound: near each seam the first difference
    stays within 5x the largest one away from the seams."""
    wav = cat(chunks)
    assert np.isfinite(wav).all()
    d = np.abs(np.diff(wav[0]))
    seams = np.cumsum([c["wav"].shape[1] for c in chunks])[:-1]
    interior = np.ones(len(d), bool)
    for sm in seams:
        interior[max(0, sm - 4):sm + 4] = False
    base = d[interior].max() if interior.any() else 0.0
    assert base > 0
    for sm in seams:
        lo, hi = max(0, sm - 4), min(len(d), sm + 4)
        assert d[lo:hi].max() <= 5.0 * base + 1e-6, (sm, d[lo:hi].max(), base)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


@pytest.fixture(scope="module")
def syn(pair):
    """tests/test_streaming.py's synthesis request, and the JAX one-shot
    synthesis and StreamingSynthesizer on it."""
    cfg, model, variables, port = pair
    r = np.random.RandomState(1)
    nq, k = (cfg.audio_tower.quantizer.num_quantizers,
             cfg.audio_tower.quantizer.codebook_size)
    n = 9
    a = {"speaker_embeds": r.randn(1, cfg.speech_decoder.spk_embed_dim
                                   ).astype(np.float32),
         "taste": r.randint(0, k, (1, 4, nq)).astype(np.int32),
         "asr_ids": r.randint(5, 100, (1, n)).astype(np.int32),
         "asr_lens": np.array([n], np.int32),
         "asr_words": np.minimum(np.arange(n) // 3, 3)[None].astype(np.int32)}
    key = jax.random.PRNGKey(3)
    args_j = tuple(jnp.asarray(v) for v in a.values())
    oneshot = jax.jit(lambda v, *x: model.apply(
        v, key, *x, max_speech_steps=MAX_SPEECH, mel_len_max=MEL_LEN_MAX,
        method=JaxTaste.synthesize_from_taste))(variables, *args_j)
    chunks = list(jax_streaming.StreamingSynthesizer(
        model, variables, max_speech_steps=MAX_SPEECH, **GEOM).stream(
            key, *args_j))
    args_p = (t(a["speaker_embeds"]),) + tuple(
        t(a[k]).long() for k in ("taste", "asr_ids", "asr_lens", "asr_words"))
    return a, args_p, oneshot, chunks, jax_draws(cfg, key, MAX_SPEECH)


# ---------------------------------------------------------------------------
# the S3 decoder: chunked and resumed decodes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def decoder(pair):
    """A batch of two ragged requests at the S3 decoder, and JAX's decodes
    on it: the one-shot decode, and a decode from a shorter text for 8
    steps resumed with the full text for 8 more."""
    cfg, model, variables, port = pair
    sd = cfg.speech_decoder
    r = np.random.RandomState(0)
    b, n = 2, 6
    x = {"spk": r.randn(b, sd.spk_embed_dim).astype(np.float32),
         "audio": r.randn(b, n, sd.audio_encoder_input_size).astype(np.float32),
         "ids": r.randint(0, sd.text_token_size, (b, n)).astype(np.int32),
         "lens": np.array([6, 4], np.int32),
         "short": np.array([4, 3], np.int32)}
    key = jax.random.PRNGKey(5)

    def run(v, spk, audio, ids, lens, short):
        dec = lambda m, *a, **kw: m.speech_decoder.generate(*a, **kw)  # noqa: E731
        oneshot = model.apply(v, key, spk, audio, lens, ids, lens,
                              max_steps=MAX_SPEECH, method=dec)
        init = lambda m, *a, **kw: m.speech_decoder.generate_stream_init(  # noqa: E731
            *a, **kw)
        chunk = lambda m, st: m.speech_decoder.generate_stream_chunk(st, 8)  # noqa: E731
        resume = lambda m, *a, **kw: m.speech_decoder.generate_stream_resume(  # noqa: E731
            *a, **kw)
        st = model.apply(v, key, spk, audio, short, ids, short,
                         max_steps=MAX_SPEECH, method=init)
        toks1, _ = model.apply(v, st, method=chunk)
        hist = jnp.zeros((b, MAX_SPEECH), jnp.int32).at[:, :8].set(
            jnp.maximum(toks1, 0))
        st = model.apply(v, key, spk, audio, lens, ids, lens, hist,
                         jnp.int32(8), max_steps=MAX_SPEECH, method=resume)
        toks2, st = model.apply(v, st, method=chunk)
        return oneshot["speech_token_ids"], toks1, toks2, st["step"]

    ref = jax.jit(run)(variables, *(jnp.asarray(v) for v in x.values()))
    gumbel = s3_gumbel(cfg, key, MAX_SPEECH, b)
    xp = {k: t(v) if v.dtype == np.float32 else t(v).long()
          for k, v in x.items()}
    return port.speech_decoder, xp, tuple(map(np.asarray, ref)), gumbel


def test_chunked_s3_decode_matches_jax_oneshot(decoder):
    dec, x, (oneshot, _, _, _), gumbel = decoder
    st = dec.generate_stream_init(x["spk"], x["audio"], x["lens"], x["ids"],
                                  x["lens"], max_steps=MAX_SPEECH,
                                  gumbel=gumbel)
    chunks = []
    for _ in range(4):
        toks, st = dec.generate_stream_chunk(st, 4)
        chunks.append(toks.numpy())
    np.testing.assert_array_equal(np.concatenate(chunks, axis=1), oneshot)
    whole = dec.generate(x["spk"], x["audio"], x["lens"], x["ids"], x["lens"],
                         max_steps=MAX_SPEECH, gumbel=gumbel)
    np.testing.assert_array_equal(whole["speech_token_ids"].numpy(), oneshot)


def test_s3_resume_matches_uninterrupted_stream(decoder):
    """With the text unchanged, re-prefill + replay of the committed 8
    tokens continues exactly as the uninterrupted stream does."""
    dec, x, (oneshot, _, _, _), gumbel = decoder
    args = (x["spk"], x["audio"], x["lens"], x["ids"], x["lens"])
    st = dec.generate_stream_init(*args, max_steps=MAX_SPEECH, gumbel=gumbel)
    toks1, st = dec.generate_stream_chunk(st, 8)
    assert (toks1 >= 0).all(), "precondition: no EOS inside the first chunk"
    ref2, _ = dec.generate_stream_chunk(st, 8)
    hist = torch.zeros((2, MAX_SPEECH), dtype=torch.long)
    hist[:, :8] = toks1
    resumed = dec.generate_stream_resume(*args, hist, 8, max_steps=MAX_SPEECH,
                                         gumbel=gumbel)
    assert resumed["step"] == 8
    got2, _ = dec.generate_stream_chunk(resumed, 8)
    np.testing.assert_array_equal(got2.numpy(), ref2.numpy())
    np.testing.assert_array_equal(got2.numpy(), oneshot[:, 8:])


def test_s3_resume_with_extended_text_matches_jax(decoder):
    dec, x, (_, toks1_j, toks2_j, step_j), gumbel = decoder
    st = dec.generate_stream_init(x["spk"], x["audio"], x["short"], x["ids"],
                                  x["short"], max_steps=MAX_SPEECH,
                                  gumbel=gumbel)
    toks1, _ = dec.generate_stream_chunk(st, 8)
    np.testing.assert_array_equal(toks1.numpy(), toks1_j)
    assert (toks1_j >= 0).all()
    hist = torch.zeros((2, MAX_SPEECH), dtype=torch.long)
    hist[:, :8] = toks1
    resumed = dec.generate_stream_resume(
        x["spk"], x["audio"], x["lens"], x["ids"], x["lens"], hist, 8,
        max_steps=MAX_SPEECH, gumbel=gumbel)
    toks2, st2 = dec.generate_stream_chunk(resumed, 8)
    np.testing.assert_array_equal(toks2.numpy(), toks2_j)
    assert st2["step"] == int(step_j)


# ---------------------------------------------------------------------------
# StreamingSynthesizer
# ---------------------------------------------------------------------------


def test_streaming_synthesis_matches_jax_per_chunk(pair, syn):
    cfg, _, _, port = pair
    a, args_p, oneshot, chunks_j, draws = syn
    chunks = list(streaming.StreamingSynthesizer(
        port, max_speech_steps=MAX_SPEECH, **GEOM).stream(
            3, *args_p, draws=draws))
    assert_same_chunks(chunks, chunks_j)
    assert chunks[-1]["is_last"]
    n = int(np.asarray(oneshot["speech_token_lengths"])[0])
    tokens = cat(chunks, "tokens")
    np.testing.assert_array_equal(
        tokens[0, :n], np.asarray(oneshot["speech_token_ids"])[0, :n])
    # the port's own one-shot synthesis reads the same draws
    one_p = port.synthesize_from_taste(*args_p, max_speech_steps=MAX_SPEECH,
                                       mel_len_max=MEL_LEN_MAX,
                                       gumbel=draws["s3_gumbel"])
    np.testing.assert_array_equal(one_p["speech_token_ids"].numpy()[0, :n],
                                  tokens[0, :n])
    wav = cat(chunks)
    spf = np.asarray(oneshot["waveform"]).shape[1] // MEL_LEN_MAX
    expect = int(np.floor(n * streaming.mel_per_token(cfg.flow))) * spf
    assert abs(wav.shape[1] - expect) <= 2 * spf * len(chunks)
    assert_seams_continuous(chunks)


@pytest.mark.parametrize("geometry", [
    dict(GEOM, first_chunk_tokens=2),
    dict(GEOM, chunk_tokens=3, first_chunk_tokens=2, chunk_schedule=(3, 6, 9))],
    ids=["small_first_chunk", "chunk_schedule"])
def test_streaming_geometry_keeps_the_tokens(pair, syn, geometry):
    """A small first chunk or a growing schedule moves the windows, not the
    decode: the same tokens as JAX's one-shot, finite chunks, a first
    chunk of at most 2 tokens, and the emitted length of the uniform
    stream within the seams' quantization."""
    _, _, _, port = pair
    a, args_p, oneshot, chunks_j, draws = syn
    chunks = list(streaming.StreamingSynthesizer(
        port, max_speech_steps=MAX_SPEECH, **geometry).stream(
            3, *args_p, draws=draws))
    n = int(np.asarray(oneshot["speech_token_lengths"])[0])
    tokens = cat(chunks, "tokens")
    np.testing.assert_array_equal(
        tokens[tokens >= 0], np.asarray(oneshot["speech_token_ids"])[0, :n])
    n_new = [c["n_new"] for c in chunks]
    assert n_new[0] <= 2 and chunks[-1]["is_last"]
    if "chunk_schedule" in geometry:
        assert max(n_new) > 3
    for c in chunks:
        assert np.isfinite(c["wav"]).all()
    n_b, n_g = cat(chunks_j).shape[1], cat(chunks).shape[1]
    spf_est = max(n_b // n, 1)
    assert abs(n_b - n_g) <= 2 * spf_est * (len(chunks) + len(chunks_j))


def test_streaming_synthesize_reports_ttfa(pair, syn):
    _, _, _, port = pair
    a, args_p, _, chunks_j, draws = syn
    wav, ttfa = streaming.StreamingSynthesizer(
        port, max_speech_steps=MAX_SPEECH, **GEOM).synthesize(
            3, *args_p, draws=draws)
    assert ttfa > 0
    assert np.max(np.abs(wav - cat(chunks_j))) <= 1e-3


def test_one_streamer_serves_interleaved_streams(pair, syn):
    """A streamer holds no per-stream state: two streams interleaved chunk
    by chunk on one instance give the chunks and the record of what ran
    that each gives alone."""
    _, _, _, port = pair
    args_p = syn[1]
    streamer = streaming.StreamingSynthesizer(port, max_speech_steps=MAX_SPEECH,
                                              **GEOM)
    seeds = (3, 4)
    alone = [list(streamer.stream(s_, *args_p)) for s_ in seeds]
    its = [streamer.stream(s_, *args_p) for s_ in seeds]
    got, live = ([], []), [0, 1]
    while live:
        for i in list(live):
            try:
                got[i].append(next(its[i]))
            except StopIteration:
                live.remove(i)
    for g, a in zip(got, alone):
        assert len(g) == len(a) > 1
        for x, y in zip(g, a):
            np.testing.assert_array_equal(x["tokens"], y["tokens"])
            np.testing.assert_array_equal(x["wav"], y["wav"])
        assert g[-1]["ran"] == a[-1]["ran"]
        assert len(g[-1]["ran"]["windows"]) == len(g)


def test_seam_emitter_is_byte_identical_to_jax():
    r = np.random.RandomState(4)
    for mpt, lc, cf in ((1.72265625, 25, 2), (1.72265625, 3, 1), (2.0, 4, 0)):
        ours, ref = (streaming._SeamEmitter(mpt, lc, cf),
                     jax_streaming._SeamEmitter(mpt, lc, cf))
        for i, n_new in enumerate((3, 5, 5, 0, 4)):
            mw = int(np.ceil((n_new + lc) * mpt)) + 4
            wav = r.randn(1, mw * 8).astype(np.float32)
            last = i == 4
            if n_new == 0:
                got, want = ours.flush(), ref.flush()
            else:
                got = ours.emit(wav, n_new, mw, last)
                want = ref.emit(wav.copy(), n_new, mw, last)
            assert (got is None) == (want is None)
            if got is not None:
                assert got.dtype == want.dtype and got.shape == want.shape
                assert got.tobytes() == want.tobytes(), (mpt, lc, cf, i)
            assert ours.s == ref.s


# ---------------------------------------------------------------------------
# CompletionStreamer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def completion(pair, syn):
    """A pipelined completion request: the first row of the completion
    tests' spoken-LM prefix, a greedy joint decode whose words arrive one a
    step until it ends at step 6, full-budget asr buffers of 12 tokens
    (tests/test_streaming.py's); and JAX's pipelined stream on it."""
    cfg, model, variables, port = pair
    a = syn[0]
    r = np.random.RandomState(7)
    v = cfg.spoken_lm.llama.vocab_size
    jd = {k: x[:1] for k, x in lm_inputs(cfg, 1).items()}
    asr = {"asr_token_ids": r.randint(5, 100, (1, 12)).astype(np.int32),
           "asr_word_ids": np.minimum(np.arange(12) // 2, 5)[None].astype(
               np.int32)}
    tables = build_sampler_tables(VocabScan(), v)
    sampler = dict(delay=cfg.spoken_lm.delay, delay_level="word",
                   extra_words=4, has_prefix=True)
    key = jax.random.PRNGKey(11)
    args_j = (jnp.asarray(a["speaker_embeds"]),) + tuple(
        jnp.asarray(x) for x in (*jd.values(), *asr.values()))
    chunks = list(jax_streaming.CompletionStreamer(
        model, variables, JaxSamplerConfig(**sampler),
        {n_: jnp.asarray(x) for n_, x in tables.items()}, jd_first_chunk=3,
        jd_chunk=4, min_start_words=1, **PIPE).stream(
            key, *args_j, max_steps=JD_STEPS))
    args_p = (t(a["speaker_embeds"]),) + tuple(
        t(x).long() for x in (*jd.values(), *asr.values()))
    tables_p = {n_: torch.from_numpy(x) for n_, x in tables.items()}
    draws = jax_draws(cfg, jax.random.split(key)[1], PIPE["max_speech_steps"])
    return (SamplerConfig(**sampler), tables_p, args_p, chunks, draws, jd,
            asr)


def _streamer(port, completion, **kw):
    scfg, tables = completion[:2]
    return streaming.CompletionStreamer(port, scfg, tables,
                                        **{**PIPE, **kw})


def test_completion_streamer_matches_jax_per_chunk(pair, completion):
    cfg, _, _, port = pair
    _, _, args_p, chunks_j, draws, _, _ = completion
    streamer = _streamer(port, completion, jd_first_chunk=3, jd_chunk=4,
                         min_start_words=1)
    chunks = list(streamer.stream(11, *args_p, max_steps=JD_STEPS,
                                  draws=draws))
    assert_same_chunks(chunks, chunks_j, ("n_new", "is_last", "jd_done",
                                          "n_words"))
    assert chunks[-1]["is_last"] and chunks[-1]["jd_done"]
    # synthesis started from a partial joint decode and re-contextualized
    assert chunks[0]["n_words"] < chunks[-1]["n_words"]
    assert chunks[-1]["ran"]["replays"] >= 1
    live = cat(chunks, "tokens")
    live = live[live >= 0]
    assert 0 < live.size <= PIPE["max_speech_steps"]
    assert (live < cfg.speech_decoder.speech_token_size).all()
    for c in chunks:
        assert np.isfinite(c["wav"]).all()


def _jd_gumbel(cfg, seed: int = 12):
    """Text [JD_STEPS, 1, V] and taste [JD_STEPS, 1, L, K] gumbel noise."""
    r = np.random.RandomState(seed)
    q = cfg.audio_tower.quantizer
    return {"text_gumbel": t(r.gumbel(size=(
                JD_STEPS, 1, cfg.spoken_lm.llama.vocab_size)).astype(np.float32)),
            "taste_gumbel": t(r.gumbel(size=(
                JD_STEPS, 1, q.num_quantizers, q.codebook_size)).astype(
                    np.float32))}


# hot enough that the tiny model's text and taste depend on the draws
SAMPLED = dict(text_top_p=1.0, taste_top_p=1.0, text_temperature=4.0)


def test_joint_decode_chunks_read_draws_by_step(pair, completion):
    """A sampled joint decode in the streamers' chunks (3, then 4 at a
    time) reads each step's draws by its absolute step: the one-shot
    decode's trajectory."""
    cfg, _, _, port = pair
    scfg, tables, args_p = completion[:3]
    scfg = scfg._replace(**SAMPLED)
    draws = _jd_gumbel(cfg)
    ref = port.generate_completion(scfg, tables, *args_p[1:5],
                                   max_steps=JD_STEPS, **draws)
    st = port.completion_stream_start(scfg, tables, *args_p[1:5],
                                      max_steps=JD_STEPS, first_chunk=3,
                                      jd_draws=draws)
    while st["step"] < JD_STEPS and not bool(st["done"].all()):
        st = port.completion_stream_chunk(st, scfg, tables, 4, draws)
    assert st["step"] == int(ref["steps"]) > 3
    for got, key in ((st["out_tokens"], "llm_token_ids"),
                     (st["out_taste"], "taste_indices"),
                     (st["n_taste"], "num_taste_words")):
        np.testing.assert_array_equal(got.numpy(), ref[key].numpy())


@pytest.mark.parametrize("jd", ["greedy", "sampled"])
def test_completion_streamer_matches_plain_stream_when_jd_first(
        pair, completion, jd):
    """With the whole joint decode in the first jd chunk there is nothing
    to pipeline: the stream equals StreamingSynthesizer on the final
    text with the same draws (a sampled joint decode's from `draws`)."""
    cfg, _, _, port = pair
    scfg, tables, args_p, _, draws, _, asr = completion
    jd_draws = {}
    if jd == "sampled":
        scfg, jd_draws = scfg._replace(**SAMPLED), _jd_gumbel(cfg)
    chunks_p = list(streaming.CompletionStreamer(
        port, scfg, tables, **PIPE, jd_first_chunk=JD_STEPS,
        min_start_words=1).stream(
        11, *args_p, max_steps=JD_STEPS, draws={**draws, **jd_draws}))
    assert chunks_p and chunks_p[-1]["is_last"]
    n_words = chunks_p[-1]["n_words"]
    assert all(c["n_words"] == n_words for c in chunks_p), "no extends"
    out = port.generate_completion(scfg, tables, *args_p[1:5],
                                   max_steps=JD_STEPS, **jd_draws)
    taste = torch.clamp(out["taste_indices"], min=0)
    lens = torch.from_numpy(np.sum(asr["asr_word_ids"] < n_words, axis=1))
    chunks_s = list(streaming.StreamingSynthesizer(
        port, first_chunk_tokens=2, max_speech_steps=12, **GEOM).stream(
            11, args_p[0], taste, args_p[5], lens, args_p[6], draws=draws))
    tok_p, tok_s = cat(chunks_p, "tokens"), cat(chunks_s, "tokens")
    np.testing.assert_array_equal(tok_p[tok_p >= 0], tok_s[tok_s >= 0])
    np.testing.assert_allclose(cat(chunks_p), cat(chunks_s), atol=1e-5)


def test_completion_streamer_reuse_with_different_max_steps(pair, completion):
    _, _, _, port = pair
    args_p, draws = completion[2], completion[4]
    kw = dict(jd_first_chunk=3, jd_chunk=4, min_start_words=1)
    streamer = _streamer(port, completion, **kw)
    small = list(streamer.stream(11, *args_p, max_steps=4, draws=draws))
    large = list(streamer.stream(11, *args_p, max_steps=JD_STEPS,
                                 draws=draws))
    expect = list(_streamer(port, completion, **kw).stream(
        11, *args_p, max_steps=JD_STEPS, draws=draws))
    assert small and small[-1]["is_last"] and large[-1]["is_last"]
    assert large[-1]["n_words"] == expect[-1]["n_words"]
    np.testing.assert_allclose(cat(large), cat(expect), atol=1e-5)


def test_completion_streamer_synthesize_drain(pair, completion):
    _, _, _, port = pair
    args_p, chunks_j, draws = completion[2], completion[3], completion[4]
    wav, ttfa = _streamer(port, completion, jd_first_chunk=3, jd_chunk=4,
                          min_start_words=1).synthesize(
        11, *args_p, max_steps=JD_STEPS, draws=draws)
    assert wav.shape[0] == 1 and np.isfinite(wav).all() and ttfa >= 0.0
    assert np.max(np.abs(wav - cat(chunks_j))) <= 1e-3


# a first S3 chunk long enough that its tokens see the words it was
# prefilled with
FALLBACK_PIPE = dict(PIPE, first_chunk_tokens=5)


@pytest.fixture(scope="module")
def sampled_fallback(pair, syn, completion):
    """JAX's pipelined stream on the completion request with a sampled
    joint decode (SAMPLED) whose first jd chunk of 1 step gives too few
    words for min_start_words = 2 (then jd chunks of 3); the taste rows,
    asr lengths and history length of each S3 (re-)prefill it ran after
    the first audio; and the port's draws for it: the text and taste
    gumbel of JAX's decode key, the S3 and voice draws of its synthesis
    key."""
    cfg, model, variables, _ = pair
    scfg, tables_p, _, _, _, jd, asr = completion
    key = jax.random.PRNGKey(3)
    args_j = (jnp.asarray(syn[0]["speaker_embeds"]),) + tuple(
        jnp.asarray(x) for x in (*jd.values(), *asr.values()))
    sampled = scfg._replace(**SAMPLED)
    streamer = jax_streaming.CompletionStreamer(
        model, variables, JaxSamplerConfig(**sampled._asdict()),
        {n_: jnp.asarray(x.numpy()) for n_, x in tables_p.items()},
        jd_first_chunk=1, jd_chunk=3, min_start_words=2, **FALLBACK_PIPE)
    prefills, jit = [], streamer._jit

    def recording_jit(name, fn):
        # (taste, asr lengths, history length) positions of syn_start's
        # and syn_extend's arguments
        at = {"syn_start": (3, 5, None)}.get(
            name, (4, 6, 9) if name.startswith("syn_extend:") else None)
        f = jit(name, fn)
        if at is None:
            return f

        def call(*a):
            prefills.append((np.asarray(a[at[0]]), np.asarray(a[at[1]]),
                             0 if at[2] is None else int(a[at[2]])))
            return f(*a)
        return call
    streamer._jit = recording_jit
    chunks = list(streamer.stream(key, *args_j, max_steps=JD_STEPS))
    rng_jd, rng_syn = jax.random.split(key)
    return sampled, chunks, prefills, {
        **jax_draws(cfg, rng_syn, PIPE["max_speech_steps"]),
        **jd_draws_jax(cfg, rng_jd, JD_STEPS)}


def test_completion_streamer_fallback_when_first_chunk_too_few_words(
        monkeypatch, pair, completion, sampled_fallback):
    """A first jd chunk with too few words: its synthesis is discarded, jd
    chunks are polled and the synthesis starts over from the same draws.
    On a sampled joint decode reading JAX's draws: JAX's chunks exactly,
    and the chunks of a streamer whose first jd chunk covers the same
    words directly; other joint-decode draws give another stream.  Each
    S3 prefill after the first audio (the fallback's start, the extends)
    gets JAX's taste rows, asr lengths and history length: the tiny
    model's flat S3 logits leave the tokens blind to them."""
    cfg, _, _, port = pair
    args_p = completion[2]
    scfg, chunks_j, prefills_j, draws = sampled_fallback
    prefills = []
    for name, at in (("stream_start_step", (1, 3, None)),
                     ("stream_extend_step", (1, 3, 6))):
        def record(*a, _real=getattr(port, name), _at=at, **kw):
            prefills.append((a[_at[0]].numpy(), a[_at[1]].numpy(),
                             0 if _at[2] is None else int(a[_at[2]])))
            return _real(*a, **kw)
        monkeypatch.setattr(port, name, record)

    def run(jd_first_chunk, draws=draws):
        chunks = list(streaming.CompletionStreamer(
            port, scfg, completion[1], **FALLBACK_PIPE,
            jd_first_chunk=jd_first_chunk,
            jd_chunk=3, min_start_words=2).stream(
                3, *args_p, max_steps=JD_STEPS, draws=draws))
        return chunks, chunks[-1]["ran"]
    fallback, ran_f = run(1)
    assert_same_chunks(fallback, chunks_j, ("n_new", "is_last", "jd_done",
                                            "n_words"))
    # the first is the first audio's own (fused in JAX)
    assert len(prefills) == len(prefills_j) + 1 == ran_f["s3_prefills"]
    for i, (got, ref) in enumerate(zip(prefills[1:], prefills_j)):
        np.testing.assert_array_equal(got[0], ref[0], err_msg=f"taste {i}")
        np.testing.assert_array_equal(got[1], ref[1], err_msg=f"lens {i}")
        assert got[2] == ref[2], (i, got[2], ref[2])
    monkeypatch.undo()
    assert ran_f["replays"] >= 1, "the steady state never extended"
    other = run(1, {**draws, **_jd_gumbel(cfg)})[0]
    assert [c["n_words"] for c in other] != [c["n_words"] for c in fallback] \
        or cat(other).shape != cat(fallback).shape \
        or np.abs(cat(other) - cat(fallback)).max() > 1e-2
    direct, ran_d = run(4)
    assert ran_f["s3_prefills"] == ran_d["s3_prefills"] + 1, "no fallback"
    assert fallback[-1]["is_last"] and direct[-1]["is_last"]
    assert fallback[-1]["n_words"] == direct[-1]["n_words"]
    wav_f = cat(fallback)
    assert np.isfinite(wav_f).all()
    np.testing.assert_allclose(wav_f, cat(direct), atol=1e-5)


# ---------------------------------------------------------------------------
# the int8 serving layout
# ---------------------------------------------------------------------------


def test_streaming_synthesis_int8_layout_matches_jax(monkeypatch, pair, syn):
    """The int8 serving layout (fused FFNs on the S3 llm stack): the stream
    runs the ffn_int8 plain version at the prefill and every decode step
    and decodes JAX's tokens (JAX's Pallas kernels in interpret mode)."""
    cfg = pair[0]
    a, args_p, _, _, _ = syn
    jcfg = serving_config(cfg, "int8", True)
    variables = quantize_variables_jax(
        jcfg, jax.tree.map(np.asarray, pair[2]), "int8", True)
    port = port_model(serving_config(TasteConfig.tiny(), "int8", True),
                      variables)
    key = jax.random.PRNGKey(3)
    steps = 8
    oneshot = jax.jit(lambda v, *x: JaxTaste(jcfg).apply(
        v, key, *x, max_speech_steps=steps, mel_len_max=MEL_LEN_MAX,
        method=JaxTaste.synthesize_from_taste))(
            jax.tree.map(jnp.asarray, variables),
            *(jnp.asarray(v) for v in a.values()))
    calls = []
    plain = fused_mlp.ffn_int8_plain
    monkeypatch.setattr(fused_mlp, "ffn_int8_plain",
                        lambda x, *w: calls.append(x.shape[:-1]) or plain(x, *w))
    streamer = streaming.StreamingSynthesizer(port, max_speech_steps=steps,
                                              **dict(GEOM, chunk_tokens=4))
    chunks = list(streamer.stream(3, *args_p,
                                  draws=jax_draws(jcfg, key, steps)))
    tokens = cat(chunks, "tokens")
    n = int(np.asarray(oneshot["speech_token_lengths"])[0])
    np.testing.assert_array_equal(
        tokens[tokens >= 0], np.asarray(oneshot["speech_token_ids"])[0, :n])
    blocks = jcfg.speech_decoder.llm.num_blocks
    rows = [int(np.prod(s)) for s in calls]
    ran = chunks[-1]["ran"]
    assert rows.count(1) == blocks * ran["s3_steps"]
    assert len(rows) == blocks * (ran["s3_steps"] + 1)
    assert_seams_continuous(chunks)


# ---------------------------------------------------------------------------
# TasteEngine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(pair):
    cfg, model, variables, port = pair
    return (JaxEngine(model, variables, cfg, token_buckets=(8, 16)),
            TasteEngine(port, port.config, token_buckets=(8, 16)))


def test_engine_bucketing_matches_jax(engines):
    jax_engine, engine = engines
    r = np.random.RandomState(2)
    for n in range(0, 20):
        assert engine._bucket(n) == jax_engine._bucket(n)
        ids, words = r.randint(0, 50, n), np.arange(n) // 2
        for got, ref in zip(engine._pad_tokens(ids, words, engine._bucket(n)),
                            jax_engine._pad_tokens(ids, words,
                                                   jax_engine._bucket(n))):
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)


def test_engine_tokenize_matches_jax(pair, engines):
    cfg = pair[0]
    jax_engine, engine = engines
    w = cfg.audio_tower.whisper
    r = np.random.RandomState(3)
    mel = r.randn(w.n_mels, 2 * w.max_source_positions).astype(np.float32)
    ids = r.randint(10, w.vocab_size, 10).tolist()
    words = (np.arange(10) // 2).tolist()
    got = engine.tokenize(mel, ids, words)
    np.testing.assert_array_equal(got, jax_engine.tokenize(mel, ids, words))
    assert got.shape == (10, cfg.audio_tower.quantizer.num_quantizers)


def test_engine_streams_equal_the_streamers(engines, syn, completion):
    """synthesize_stream / complete_stream pad to the bucket and yield the
    chunks of the port's streamers on the padded inputs."""
    _, engine = engines
    a = syn[0]
    port = engine.model
    taste = a["taste"][0]
    ids, words = a["asr_ids"][0].tolist(), a["asr_words"][0].tolist()
    got = list(engine.synthesize_stream(taste, ids, words,
                                        a["speaker_embeds"][0], max_steps=12,
                                        chunk_tokens=5, seed=9))
    taste_pad = np.zeros((1, 16, taste.shape[1]), np.int64)
    taste_pad[0, :len(taste)] = taste
    p_ids, p_lens, p_words = engine._pad_tokens(ids, words, 16)
    ref = list(streaming.StreamingSynthesizer(
        port, chunk_tokens=5, left_ctx_tokens=2, max_speech_steps=12).stream(
            9, t(a["speaker_embeds"]), t(taste_pad), *(t(x).long() for x in (
                p_ids, p_lens, p_words))))
    assert len(got) == len(ref) > 0
    for (wav, last, n_new), r in zip(got, ref):
        np.testing.assert_array_equal(wav, r["wav"][0])
        assert (last, n_new) == (r["is_last"], r["n_new"])

    scfg, tables, _, _, _, jd, asr = completion
    engine._tables = tables        # a deployment's tables (the default
                                   # ones start no word on these weights)
    sampler = {k: v for k, v in scfg._asdict().items() if k != "delay"}
    llm_ids = jd["llm_token_ids"][0].tolist()
    llm_words = jd["llm_word_ids"][0].tolist()
    a_ids, a_words = asr["asr_token_ids"][0], asr["asr_word_ids"][0]
    got = list(engine.complete_stream(
        llm_ids, llm_words, jd["llm_indices"][0], a_ids.tolist(),
        a_words.tolist(), a["speaker_embeds"][0], sampler, seed=9,
        max_steps=JD_STEPS, max_speech_steps=12, chunk_tokens=5,
        first_chunk_tokens=2, jd_first_chunk=3))
    l_ids, l_lens, l_words = engine._pad_tokens(llm_ids, llm_words, 16)
    pa_ids, _, pa_words = engine._pad_tokens(a_ids, a_words, 16)
    n = len(llm_ids)
    idx = np.full((1, 16, jd["llm_indices"].shape[-1]), -1, np.int64)
    idx[0, :n] = jd["llm_indices"][0, :n]
    ref = list(streaming.CompletionStreamer(
        port, SamplerConfig(delay=port.config.spoken_lm.delay, **sampler),
        engine._get_tables(), chunk_tokens=5, left_ctx_tokens=2,
        first_chunk_tokens=2, jd_first_chunk=3, jd_chunk=3,
        max_speech_steps=12).stream(
            9, t(a["speaker_embeds"]), t(idx), *(t(x).long() for x in (
                l_ids, l_lens, l_words, pa_ids, pa_words)),
            max_steps=JD_STEPS, asr_valid_len=12))
    assert len(got) == len(ref) > 0
    for (wav, last, n_new, n_words), r in zip(got, ref):
        np.testing.assert_array_equal(wav, r["wav"][0])
        assert (last, n_new, n_words) == (r["is_last"], r["n_new"],
                                          r["n_words"])


class _ReconstructSpy:
    """A model or compiled function that records the arguments of its
    reconstruction call and returns a 4-sample waveform of 2 tokens."""

    device = torch.device("cpu")

    def __init__(self):
        self.calls = []

    def _record(self, args, kw):
        self.calls.append((args, kw))

    def inference_reconstruction(self, *args, **kw):
        self._record(args, kw)
        return {"waveform": torch.zeros((1, 8)),
                "waveform_lengths": torch.tensor([4]),
                "speech_token_lengths": torch.tensor([2])}


class _JitRecorder(dict):
    """JAX's engine jit cache, answering every key with a spy."""

    def __init__(self):
        super().__init__()
        self.keys, self.spy = [], _ReconstructSpy()

    def __contains__(self, key):
        return True

    def __getitem__(self, key):
        self.keys.append(key)

        def fn(*args):
            self.spy._record(args, {})
            return {"waveform": np.zeros((1, 8), np.float32),
                    "waveform_lengths": np.array([4]),
                    "speech_token_lengths": np.array([2])}
        return fn


def _reconstruct_request(cfg, n=10, seed=3):
    w = cfg.audio_tower.whisper
    r = np.random.RandomState(seed)
    return (r.randn(w.n_mels, 2 * w.max_source_positions).astype(np.float32),
            r.randint(10, w.vocab_size, n).tolist(), (np.arange(n) // 2).tolist(),
            r.randn(cfg.speech_decoder.spk_embed_dim).astype(np.float32))


@pytest.mark.parametrize("max_steps", [1, 12, 128, 512, 1000])
def test_engine_reconstruct_passes_jax_engines_arguments(pair, max_steps):
    """The engine calls inference_reconstruction with the arguments JAX's
    engine gives it, in JAX's order (after its key): the bucket-padded
    speaker, ids, lengths, word ids and mel, max_speech_steps and
    mel_len_max."""
    cfg, model, variables, _ = pair
    jax_engine = JaxEngine(model, variables, cfg, token_buckets=(8, 16))
    jax_engine._jits = _JitRecorder()
    spy = _ReconstructSpy()
    engine = TasteEngine(spy, cfg, token_buckets=(8, 16))
    mel, ids, words, spk = _reconstruct_request(cfg)
    jax_engine.reconstruct(mel, ids, words, spk, max_steps, 5)
    wav, sr, n_tok, rtf = engine.reconstruct(mel, ids, words, spk, max_steps, 5)
    (key,) = jax_engine._jits.keys
    (args_j, _), = jax_engine._jits.spy.calls
    (args_p, kw), = spy.calls
    assert kw["max_speech_steps"] == key[2] == max_steps
    assert kw["mel_len_max"] == key[3]
    assert len(args_p) == len(args_j) - 2       # JAX's variables and key
    for got, ref in zip(args_p, args_j[2:]):
        assert tuple(got.shape) == np.shape(ref)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert kw["generator"].initial_seed() == 5
    assert wav.shape == (4,) and sr == cfg.hift.sampling_rate and n_tok == 2


def test_engine_reconstruct_matches_jax_engine(monkeypatch, pair, engines):
    """engine.reconstruct against JAX's engine on one request, the port's
    model reading the draws of JAX's request key (the S3 gumbel from the
    decode key's split chain, the voice noise from the vocoder key): the
    same S3 token count and sample rate, the waveform within 1e-3."""
    cfg = pair[0]
    jax_engine, engine = engines
    mel, ids, words, spk = _reconstruct_request(cfg)
    want = jax_engine.reconstruct(mel, ids, words, spk, 12, 5)
    k_dec, k_voc = jax.random.split(jnp.asarray(JaxEngine._host_key(5)))
    real = engine.model.inference_reconstruction

    def with_jax_draws(*args, generator, max_speech_steps, mel_len_max):
        z, phase, noise = voice_noise(k_voc, 1, mel_len_max, cfg)
        return real(*args, max_speech_steps=max_speech_steps,
                    mel_len_max=mel_len_max,
                    gumbel=s3_gumbel(cfg, k_dec, max_speech_steps), z=t(z),
                    source_phase=t(phase), source_noise=t(noise))
    monkeypatch.setattr(engine.model, "inference_reconstruction",
                        with_jax_draws)
    wav, sr, n_tok, rtf = engine.reconstruct(mel, ids, words, spk, 12, 5)
    assert (sr, n_tok) == tuple(want[1:3]) and n_tok > 0 and rtf > 0
    assert wav.shape == want[0].shape and wav.size > 0
    assert np.max(np.abs(wav - want[0])) <= 1e-3
