"""The port's audio frontend (ops/audio.py kaldi_fbank,
speaker_fbank_features, resample), its processor (frontend/processor.py
split_words, dual_tokenize, transcribe_with_fallback, TasteProcessor) and
its whisper ASR (models/whisper.py WhisperForASR) against the JAX package
on the CPU.

Tolerances: 1e-4 relative to the largest reference value on features and
audio (float32 FFTs and sums in another order); exact on token ids and
word ids; the ASR's average logprob within 1e-4.  The ASR runs on the
audio tower of the tiny pair's weights (TasteConfig.tiny(), through
convert.py), as scripts/generate_audio.py shares the tower's parameters;
a sampled decode reads JAX's draws, the gumbel of each step's split key.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taste_spokenlm_tpu.frontend import processor as jax_processor
from taste_spokenlm_tpu.models.whisper import WhisperForASR as JaxASR
from taste_spokenlm_tpu.ops import audio as jax_audio
from taste_spokenlm_tpu_torch.frontend import processor
from taste_spokenlm_tpu_torch.models.whisper import WhisperForASR
from taste_spokenlm_tpu_torch.ops import audio

from torch_parity_common import rel_err, t, tiny_pair

torch.set_num_threads(2)
REL = 1e-4


def _wav(n, sr, seed=0):
    r = np.random.RandomState(seed)
    k = np.arange(n)
    return (0.3 * np.sin(k * 2 * np.pi * 220 / sr)
            + 0.1 * np.sin(k * 2 * np.pi * 3100 / sr)
            + 0.05 * r.randn(n)).astype(np.float32)


# ---------------------------------------------------------------------------
# audio ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["kaldi_fbank", "speaker_fbank_features"])
def test_fbank_matches_jax(fn):
    wav = np.stack([_wav(16000, 16000, 1), _wav(16000, 16000, 2)])
    ref = getattr(jax_audio, fn)(jnp.asarray(wav))
    got = getattr(audio, fn)(torch.from_numpy(wav))
    assert got.shape == ref.shape == (2, 98, 80)
    assert rel_err(got.numpy(), ref) <= REL
    np.testing.assert_array_equal(audio.mel_filterbank_kaldi(),
                                  jax_audio.mel_filterbank_kaldi())


@pytest.mark.parametrize("sr", [24000, 22050, 8000])
def test_resample_to_16k_matches_jax(sr):
    wav = np.stack([_wav(sr // 2, sr, 3), _wav(sr // 2, sr, 4)])
    ref = jax_audio.resample(jnp.asarray(wav), sr, 16000)
    got = audio.resample(torch.from_numpy(wav), sr, 16000)
    assert got.shape == ref.shape == (2, 8000)
    assert rel_err(got.numpy(), ref) <= REL


def test_windows_and_frame_lengths_match_jax():
    for fn in ("hann_window", "povey_window"):
        np.testing.assert_allclose(getattr(audio, fn)(400).numpy(),
                                   getattr(jax_audio, fn)(400), atol=1e-7)
    x = np.arange(1000, dtype=np.float32)[None]
    np.testing.assert_array_equal(
        audio.frame_signal(torch.from_numpy(x), 400, 160).numpy(),
        jax_audio.frame_signal(jnp.asarray(x), 400, 160))
    for n in (0, 159, 160, 480000):
        assert audio.mel_frame_length(n) == jax_audio.mel_frame_length(n)


# ---------------------------------------------------------------------------
# text and the processor
# ---------------------------------------------------------------------------


class FakeTokenizer:
    """tests/test_frontend.py's toy tokenizer: ceil(len / split) ids a word."""

    def __init__(self, offset=0, split=1):
        self.offset, self.split = offset, split

    def encode(self, word, add_special_tokens=False):
        n = max(1, (len(word) + self.split - 1) // self.split)
        return [self.offset + (hash(word) + i) % 100 for i in range(n)]


@pytest.mark.parametrize("text", ["hello world  foo", " a\tb\nc ", "one"])
def test_split_words_and_dual_tokenize_match_jax(text):
    words = processor.split_words(text)
    assert words == jax_processor.split_words(text)
    asr, llm = FakeTokenizer(0, 2), FakeTokenizer(1000, 3)
    got = processor.dual_tokenize(words, asr, llm)
    ref = jax_processor.dual_tokenize(words, asr, llm)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])


def _retry_asr(calls):
    """tests/test_frontend.py: row 1 fails the logprob threshold greedy and
    passes at the next temperature."""
    def asr(mel, max_tokens, temperature, rng):
        calls.append((temperature, rng))
        toks = np.full((mel.shape[0], 4), 7, np.int32)
        if temperature == 0.0:
            lp = np.asarray([-0.1, -3.0])
            toks[1] = 9
        else:
            lp = np.asarray([-0.05, -0.2])
            toks[:] = 11
        return toks, lp
    return asr


class _RepeatTok:
    def decode(self, ids, skip_special_tokens=True):
        if all(i == 9 for i in ids):
            return "the the the the the the the the the the the the"
        return "a perfectly normal varied sentence with many words"


def _repeat_asr(calls):
    """tests/test_frontend.py: greedy text that zlib-compresses too well."""
    def asr(mel, max_tokens, temperature, rng):
        calls.append((temperature, rng))
        return (np.full((1, 12), 9 if temperature == 0.0 else 3, np.int32),
                np.asarray([-0.1]))
    return asr


@pytest.mark.parametrize("case", ["logprob", "compression_ratio", "all_pass"])
def test_transcribe_with_fallback_matches_jax(case):
    kw = {"logprob": dict(temperatures=(0.0, 0.4), logprob_threshold=-1.0),
          "compression_ratio": dict(tokenizer=_RepeatTok(),
                                    temperatures=(0.0, 0.5),
                                    compression_ratio_threshold=2.0),
          "all_pass": dict(temperatures=(0.0, 0.3, 0.6),
                           logprob_threshold=-5.0)}[case]
    make = _repeat_asr if case == "compression_ratio" else _retry_asr
    b = 1 if case == "compression_ratio" else 2
    mel = np.zeros((b, 8, 16), np.float32)
    calls_j, calls_p = [], []
    ref = jax_processor.transcribe_with_fallback(make(calls_j), mel, seed=4,
                                                 **kw)
    got = processor.transcribe_with_fallback(make(calls_p), mel, seed=4, **kw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert [c[0] for c in calls_p] == [c[0] for c in calls_j]
    # rung i draws from a generator seeded seed + i, as JAX from PRNGKey
    for i, ((_, gen), (_, key)) in enumerate(zip(calls_p, calls_j)):
        assert gen.initial_seed() == 4 + i
        np.testing.assert_array_equal(key, jax.random.PRNGKey(4 + i))


def _hooks():
    """Stub hooks that depend on what they are given: the x-vector from the
    fbank's statistics, the S3 ids from the frame count, the transcript
    fixed."""
    def embed(feats):
        f = np.asarray(feats)
        return np.resize(np.concatenate([f.std(axis=(0, 1)),
                                         f[0, :4].reshape(-1)]), 192)
    return dict(speaker_embedder=embed,
                s3_tokenizer=lambda mel, n: np.arange(int(n) // 2 % 50,
                                                      dtype=np.int32),
                transcriber=lambda wav: f"hello world {len(wav) % 97}")


@pytest.mark.parametrize("sr", [16000, 24000])
def test_processor_end_to_end_matches_jax(sr):
    toks = dict(asr_tokenizer=FakeTokenizer(0, 2),
                llm_tokenizer=FakeTokenizer(1000, 3))
    ref_proc = jax_processor.TasteProcessor(**toks, **_hooks())
    proc = processor.TasteProcessor(**toks, **_hooks(), device="cpu")
    wav = _wav(sr, sr, 5)
    refs = [_wav(sr // 2, 16000, 6), _wav(sr // 3, 16000, 7)]
    ref = ref_proc(wav, sr, ref_audio_list=refs)
    got = proc(wav, sr, ref_audio_list=refs)
    assert got.keys() == ref.keys()
    assert got["audio_features"].shape == (1, 128, 3000)
    assert got["audio_feature_lengths"][0] == 100
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        if k in ("audio_features", "speaker_embeds"):
            assert rel_err(got[k], ref[k]) <= REL, k
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(np.linalg.norm(got["speaker_embeds"][0]), 1.0,
                               rtol=1e-5)
    text = proc.process_text("hello there world")
    for k, v in ref_proc.process_text("hello there world").items():
        np.testing.assert_array_equal(text[k], v)


def test_processor_needs_text_without_transcriber():
    proc = processor.TasteProcessor(asr_tokenizer=FakeTokenizer(),
                                    llm_tokenizer=FakeTokenizer(), device="cpu")
    with pytest.raises(ValueError, match="transcriber"):
        proc(_wav(1600, 16000), 16000)


# ---------------------------------------------------------------------------
# whisper ASR
# ---------------------------------------------------------------------------

MAX_TOKENS = 8


@pytest.fixture(scope="module")
def asr():
    """(JAX apply, JAX variables, port WhisperForASR, mel [2, 128, 192])
    sharing the tiny pair's audio tower."""
    cfg, _, variables, port = tiny_pair()
    w = cfg.audio_tower.whisper
    p = variables["params"]["audio_tower"]
    asr_vars = {"params": {"encoder": p["encoder"], "decoder": p["decoder"]}}
    model = JaxASR(w)
    apply = jax.jit(lambda v, mel, temp, rng: model.apply(
        v, mel, max_tokens=MAX_TOKENS, temperature=temp, rng=rng))
    mel = np.random.RandomState(8).randn(
        2, w.n_mels, 2 * w.max_source_positions).astype(np.float32)
    return (apply, asr_vars, WhisperForASR.from_tower(port.audio_tower), mel,
            w)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _asr_gumbel(key, steps, b, v):
    """The gumbel of each step of JAX's ASR decode on `key`: the step key
    from the split chain, as jax.random.categorical draws it."""
    def body(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.gumbel(sub, (b, v), jnp.float32)
    return jax.lax.scan(body, key, None, length=steps)[1]


@pytest.mark.parametrize("temperature", [0.0, 1.5])
def test_whisper_asr_matches_jax(asr, temperature):
    apply, asr_vars, port_asr, mel, w = asr
    key = jax.random.PRNGKey(9)
    tok_j, lp_j = apply(asr_vars, jnp.asarray(mel), jnp.float32(temperature),
                        key)
    gumbel = t(_asr_gumbel(key, MAX_TOKENS, 2, w.vocab_size))
    tok_p, lp_p = port_asr(t(mel), max_tokens=MAX_TOKENS,
                           temperature=temperature, gumbel=gumbel)
    np.testing.assert_array_equal(tok_p.numpy(), np.asarray(tok_j))
    np.testing.assert_allclose(lp_p.numpy(), np.asarray(lp_j), atol=1e-4)
    toks = tok_p.numpy()
    assert toks.shape == (2, MAX_TOKENS)
    non_eos = toks[toks != w.eos_token_id]
    assert not np.isin(non_eos, w.suppress_ids).any()
    assert (non_eos < w.timestamp_begin_id).all()
    if temperature > 0:
        # the draws matter: other noise gives another decode
        other, _ = port_asr(t(mel), max_tokens=MAX_TOKENS,
                            temperature=temperature,
                            generator=torch.Generator().manual_seed(1))
        assert not torch.equal(other, tok_p)


def test_transcribe_with_fallback_over_whisper_asr(asr):
    """The fallback ladder over both ASRs: the greedy rung agrees exactly
    and every row ends with the same temperature."""
    apply, asr_vars, port_asr, mel, _ = asr
    kw = dict(max_tokens=MAX_TOKENS, temperatures=(0.0,), seed=3)
    ref = jax_processor.transcribe_with_fallback(
        lambda m, n, temp, rng: apply(asr_vars, jnp.asarray(m),
                                      jnp.float32(temp), rng), mel, **kw)
    got = processor.transcribe_with_fallback(
        lambda m, n, temp, gen: port_asr(t(m), max_tokens=n, temperature=temp,
                                         generator=gen), mel, **kw)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], atol=1e-4)
    np.testing.assert_array_equal(got[2], ref[2])


def test_whisper_asr_masks_hold_against_boosted_tokens(asr):
    """The begin-suppress, suppress and timestamp masks decide the decode:
    the tied embedding rows of a begin-suppressed, two suppressed and one
    timestamp id are set to outscore every other token at the first step,
    in both models.  Both emit the same ids: none of the four at the first
    step, the begin-suppressed one after it, never a suppressed or a
    timestamp id."""
    apply, asr_vars, port_asr, mel, w = asr
    boosted = [w.begin_suppress_ids[0], *w.suppress_ids[:2],
               w.timestamp_begin_id]
    port = WhisperForASR(w, copy.deepcopy(port_asr.encoder),
                         copy.deepcopy(port_asr.decoder))
    first = []
    hook = port.decoder.register_forward_hook(
        lambda mod, args, out: first.append(out[0][:, -1]) if not first
        else None)
    port(t(mel), max_tokens=1)
    hook.remove()
    h0 = first[0].mean(0)
    table = port.decoder.embed_tokens.weight
    with torch.no_grad():
        top = (first[0] @ table.T).abs().max()
        table[boosted] = (4 * top / h0.square().sum()) * h0
    dec = dict(asr_vars["params"]["decoder"])
    dec["embed_tokens"] = {"embedding": jnp.asarray(table.detach().numpy())}
    jax_vars = {"params": dict(asr_vars["params"], decoder=dec)}
    # unmasked, the boosted ids win the first step
    assert set((first[0] @ table.T).argmax(-1).tolist()) <= set(boosted)
    tok_j, lp_j = apply(jax_vars, jnp.asarray(mel), jnp.float32(0.0),
                        jax.random.PRNGKey(0))
    tok_p, lp_p = port(t(mel), max_tokens=MAX_TOKENS)
    np.testing.assert_array_equal(tok_p.numpy(), np.asarray(tok_j))
    np.testing.assert_allclose(lp_p.numpy(), np.asarray(lp_j), atol=1e-4)
    toks = tok_p.numpy()
    assert not np.isin(toks[:, 0], boosted).any()
    assert (toks[:, 1:] == boosted[0]).any()
    assert not np.isin(toks, boosted[1:]).any()


def test_standalone_whisper_asr_builds_on_its_device(monkeypatch, asr):
    """A WhisperForASR that builds its own modules builds them on its
    device, CUDA unless asked for the CPU, and raises without it; the
    fallback ladder draws each rung on the device of the mel it is given."""
    w = asr[4]
    cpu = WhisperForASR(w, device="cpu")
    assert {p.device.type for p in cpu.parameters()} == {"cpu"}
    assert cpu.suppress_mask.device.type == "cpu"
    gens = []

    def apply(m, n, temp, gen):
        gens.append(gen)
        return cpu(m, max_tokens=n, temperature=temp, generator=gen)
    mel = t(asr[3][:1])
    tokens, lp, temps = processor.transcribe_with_fallback(
        apply, mel, max_tokens=4, temperatures=(0.0, 1.0),
        logprob_threshold=0.0, seed=6)
    assert tokens.shape == (1, 4) and np.isfinite(lp).all()
    assert temps.tolist() == [1.0]
    assert [(g.device, g.initial_seed()) for g in gens] == [
        (mel.device, 6), (mel.device, 7)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WhisperForASR(w)
