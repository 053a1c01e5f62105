"""The port's reconstruction slice (wav/mel -> taste -> S3 -> mel -> wav)
against the same composition in JAX at TasteConfig.tiny(), float32 on the
CPU: tower -> speech_decoder.generate(sampling_k=1) -> voice_generator, as
bench.py composes it, with the voice generator's noise derived by the JAX
split chain and handed to the port.

Taste indices and the greedy S3 trajectory must be equal exactly, the mel
within 1e-4 relative, the waveform within 1e-3 absolute (the sine source's
f32 phase cumsum runs in another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_common import inputs, rel_err, t, tiny_pair, voice_noise

torch.set_num_threads(2)
MAX_STEPS, MEL_LEN_MAX = 32, 48


@pytest.fixture(scope="module")
def pair():
    cfg, model, variables, port = tiny_pair()
    return cfg, model, variables, port, inputs(cfg)


def _jax(pair, fn, *args):
    _, model, variables, _, _ = pair
    return jax.jit(lambda v, *a: model.apply(v, *a, method=fn))(variables, *args)


def _port_args(d):
    return (t(d["speaker_embeds"]), t(d["asr_token_ids"]).long(),
            t(d["asr_token_lengths"]).long(), t(d["asr_word_ids"]).long(),
            t(d["audio_features"]))


def test_inference_reconstruction_matches_jax(pair):
    cfg, _, _, port, d = pair
    j = {k: jnp.asarray(v) for k, v in d.items()}
    enc = _jax(pair, lambda m, *a: m.audio_tower(*a), j["audio_features"],
               j["asr_token_ids"], j["asr_token_lengths"], j["asr_word_ids"])
    gen = _jax(pair, lambda m, *a: m.speech_decoder.generate(
        jax.random.PRNGKey(1), *a, max_steps=MAX_STEPS, sampling_k=1),
        j["speaker_embeds"], enc["audio_unit_embeds"],
        enc["audio_unit_lengths"], j["asr_token_ids"], j["asr_token_lengths"])
    tokens = jnp.maximum(gen["speech_token_ids"], 0)
    rng_voc = jax.random.PRNGKey(2)
    wav, wav_len = _jax(pair, lambda m, *a: m.voice_generator(
        rng_voc, *a, MEL_LEN_MAX), tokens, gen["speech_token_lengths"],
        j["speaker_embeds"])
    mel, _ = _jax(pair, lambda m, *a: m.voice_generator.flow.inference(
        jax.random.split(rng_voc)[0], *a, MEL_LEN_MAX), tokens,
        gen["speech_token_lengths"], j["speaker_embeds"])
    z, phase, noise = voice_noise(rng_voc, 2, MEL_LEN_MAX, cfg)

    out = port.inference_reconstruction(
        *_port_args(d), max_speech_steps=MAX_STEPS, mel_len_max=MEL_LEN_MAX,
        sampling_k=1, z=t(z), source_phase=t(phase), source_noise=t(noise))

    np.testing.assert_array_equal(out["quantized_indices"].numpy(),
                                  np.asarray(enc["quantized_indices"]))
    np.testing.assert_array_equal(out["speech_token_ids"].numpy(),
                                  np.asarray(gen["speech_token_ids"]))
    np.testing.assert_array_equal(out["speech_token_lengths"].numpy(),
                                  np.asarray(gen["speech_token_lengths"]))
    assert (out["speech_token_lengths"].numpy() > 0).all()
    got_mel, _ = port.voice_generator.flow.inference(
        torch.clamp(out["speech_token_ids"], min=0),
        out["speech_token_lengths"], t(d["speaker_embeds"]), MEL_LEN_MAX, z=t(z))
    assert rel_err(got_mel.numpy(), mel) <= 1e-4
    np.testing.assert_array_equal(out["waveform_lengths"].numpy(),
                                  np.asarray(wav_len))
    assert out["waveform"].shape == wav.shape == (2, MEL_LEN_MAX * 64)
    assert np.max(np.abs(out["waveform"].numpy() - np.asarray(wav))) <= 1e-3


def test_extract_vq_matches_jax(pair):
    _, _, _, port, d = pair
    llm_ids = np.array([[3, 4, 5, 6, 7, 8, 9], [3, 4, 5, 6, 7, 1, 1]], np.int32)
    llm_lens = np.array([7, 5], np.int32)
    llm_wids = np.array([[0, 1, 1, 2, 3, 4, 4], [0, 0, 1, 2, 3, 0, 0]], np.int32)
    asr = [d[k] for k in ("asr_token_ids", "asr_token_lengths", "asr_word_ids")]
    args = (*asr, llm_ids, llm_lens, llm_wids, d["audio_features"])
    ref = _jax(pair, lambda m, *a: m.extract_vq(*a), *map(jnp.asarray, args))
    got = port.extract_vq(*(t(a).long() for a in args[:-1]), t(args[-1]))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert (got[1][1, 5:] == -1).all()


def test_vocode_matches_jax_and_clamps_markers(pair):
    cfg, _, _, port, d = pair
    r = np.random.RandomState(3)
    tokens = r.randint(0, cfg.speech_decoder.speech_token_size, (2, 10))
    tokens[0, -1] = cfg.speech_decoder.speech_token_size     # an EOS marker
    tokens = tokens.astype(np.int32)
    lens = np.array([10, 7], np.int32)
    rng = jax.random.PRNGKey(4)
    ref = _jax(pair, lambda m, *a: m.vocode(rng, *a, 32), jnp.asarray(tokens),
               jnp.asarray(lens), jnp.asarray(d["speaker_embeds"]))
    z, phase, noise = voice_noise(rng, 2, 32, cfg)
    got = port.vocode(t(tokens).long(), t(lens).long(), t(d["speaker_embeds"]),
                      32, z=t(z), source_phase=t(phase), source_noise=t(noise))
    assert np.isfinite(got["waveform"].numpy()).all()
    np.testing.assert_array_equal(got["waveform_lengths"].numpy(),
                                  np.asarray(ref["waveform_lengths"]))
    assert np.max(np.abs(got["waveform"].numpy()
                         - np.asarray(ref["waveform"]))) <= 1e-3


def test_spoken_llm_mode_names_its_roadmap_item(pair):
    port, d = pair[3], pair[4]
    with pytest.raises(NotImplementedError, match="queue A item 8"):
        port.inference_reconstruction(*_port_args(d), mode="SpokenLLM")
