"""Each module of the PyTorch port against its JAX counterpart at
TasteConfig.tiny(), float32 on the CPU, with the same weights (loaded
through taste_spokenlm_tpu_torch.convert, strict=True) and the same inputs
and noise.  Tolerance: 1e-4 relative to the largest reference value on
floats (float32 with another summation order); exact on indices and
token ids.  Also: the copied config, the import boundary of the port and
its refusal to run without CUDA unless asked for the CPU.
"""

import ast
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taste_spokenlm_tpu import config as jax_config
from taste_spokenlm_tpu.models import flow as jax_flow
from taste_spokenlm_tpu.models import hift as jax_hift
from taste_spokenlm_tpu.ops import attention as jax_attention
from taste_spokenlm_tpu.ops import audio as jax_audio
from taste_spokenlm_tpu.ops import sampling as jax_sampling
from taste_spokenlm_tpu.ops import segment as jax_segment
from taste_spokenlm_tpu.ops.pallas import conv1d as jax_conv1d
from taste_spokenlm_tpu.ops.pallas import fused_dit as jax_fused_dit
from taste_spokenlm_tpu_torch import config as port_config
from taste_spokenlm_tpu_torch import convert
from taste_spokenlm_tpu_torch.models import flow as port_flow
from taste_spokenlm_tpu_torch.models import hift as port_hift
from taste_spokenlm_tpu_torch.models.quantizer import codebook_output_from_indices
from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM
from taste_spokenlm_tpu_torch.ops import attention, audio, sampling, segment

from torch_parity_common import (hift_noise, inputs, random_params, rel_err, t,
                                 tiny_pair)

torch.set_num_threads(2)
REL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    cfg, model, variables, port = tiny_pair()
    d = inputs(cfg)
    return cfg, model, variables, port, d


def _apply(pair, fn, *args):
    """The JAX model's `fn(module, *args)`, jitted (one compile costs less
    than dispatching the ops one by one)."""
    _, model, variables, _, _ = pair
    return jax.jit(lambda v, *a: model.apply(v, *a, method=fn))(variables, *args)


# ---------------------------------------------------------------------------
# config, import boundary, device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["full", "tiny"])
def test_config_copy_serializes_like_jax(preset):
    jc = getattr(jax_config.TasteConfig, preset)()
    pc = getattr(port_config.TasteConfig, preset)()
    assert pc.to_dict() == jc.to_dict()
    # JSON written by either package reads back the same in the other
    blob = json.loads(json.dumps(pc.to_dict()))
    assert (jax_config.TasteConfig.from_dict(blob).to_dict()
            == port_config.TasteConfig.from_dict(blob).to_dict())


def _port_sources():
    root = os.path.join(REPO, "taste_spokenlm_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax_and_no_jax_package():
    banned = ("jax", "flax", "taste_spokenlm_tpu")
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in banned, f"{path} imports {name}"


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config.TasteConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TasteForCausalLM(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TasteForCausalLM(cfg, device="cuda")
    assert TasteForCausalLM(cfg, device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def test_whisper_log_mel_matches_jax():
    r = np.random.RandomState(3)
    wav = (0.3 * np.sin(np.arange(24000) * 2 * np.pi * 220 / 16000)
           + 0.05 * r.randn(24000)).astype(np.float32)[None]
    ref = jax_audio.whisper_log_mel(jnp.asarray(wav), n_samples=32000)
    got = audio.whisper_log_mel(torch.from_numpy(wav), n_samples=32000)
    assert got.shape == ref.shape == (1, 128, 200)
    assert rel_err(got.numpy(), ref) <= REL
    np.testing.assert_array_equal(audio.mel_filterbank_slaney(),
                                  jax_audio.mel_filterbank_slaney())


def test_multi_head_attention_matches_jax():
    r = np.random.RandomState(4)
    q, k, v = (r.randn(2, 7, 2, 8).astype(np.float32) for _ in range(3))
    mask = np.tril(np.ones((7, 7), bool))[None, None] & \
        (np.arange(7) < np.array([7, 4])[:, None])[:, None, None, :]
    ref = jax_attention.multi_head_attention(*map(jnp.asarray, (q, k, v)),
                                             mask=jnp.asarray(mask))
    got = attention.multi_head_attention(*map(torch.from_numpy, (q, k, v)),
                                         mask=torch.from_numpy(mask))
    assert rel_err(got.numpy(), ref) <= REL


def test_segment_ops_match_jax():
    r = np.random.RandomState(5)
    feats = r.randn(2, 6, 3).astype(np.float32)
    wid = np.array([[0, 0, 1, 2, 2, 2], [0, 1, 1, 2, 0, 0]], np.int32)
    lens = np.array([6, 4], np.int32)
    ref = jax_segment.segment_mean_pool(jnp.asarray(feats), jnp.asarray(wid),
                                        jnp.asarray(lens))
    got = segment.segment_mean_pool(t(feats), t(wid).long(), t(lens).long())
    assert rel_err(got.numpy(), ref) <= REL

    dst = np.array([[0, 1, 1, 2, 2], [0, 0, 1, 2, 0]], np.int32)
    dlen = np.array([5, 4], np.int32)
    m_ref = jax_segment.word_start_remap(*map(jnp.asarray, (wid, lens, dst, dlen)))
    m = segment.word_start_remap(t(wid).long(), t(lens).long(), t(dst).long(),
                                 t(dlen).long())
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    vals = r.randint(0, 500, (2, 6, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        segment.remap_gather(m, t(vals)).numpy(),
        np.asarray(jax_segment.remap_gather(m_ref, jnp.asarray(vals))))

    seg_a = r.randn(2, 3, 2).astype(np.float32)
    seg_b = r.randn(2, 4, 2).astype(np.float32)
    la, lb = np.array([3, 1], np.int32), np.array([2, 4], np.int32)
    ref_p, ref_l = jax_segment.ragged_concat(
        [(jnp.asarray(seg_a), jnp.asarray(la)), (jnp.asarray(seg_b), jnp.asarray(lb))], 8)
    got_p, got_l = segment.ragged_concat(
        [(t(seg_a), t(la)), (t(seg_b), t(lb))], 8)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))


@pytest.mark.parametrize("top_k,temperature", [(5, 1.0), (1, 1.0), (20, 0.7)])
def test_sample_matches_jax_with_the_same_gumbel_noise(top_k, temperature):
    r = np.random.RandomState(6)
    logits = r.randn(3, 33).astype(np.float32) * 3
    banned = np.zeros(33, bool)
    banned[[2, 9]] = True
    forbid = np.array([True, False, True])
    jax_sample = jax.jit(functools.partial(
        jax_sampling.sample, temperature=temperature, top_k=top_k, eos_id=32))
    for i in range(4):
        key = jax.random.PRNGKey(i)
        ref = jax_sample(key, jnp.asarray(logits), banned=jnp.asarray(banned),
                         forbid_eos=jnp.asarray(forbid))
        g = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
        got = sampling.sample(t(logits), temperature, top_k=top_k,
                              banned=t(banned), forbid_eos=t(forbid),
                              eos_id=32, gumbel=t(g))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert not np.isin(got.numpy(), [2, 9]).any()


# ---------------------------------------------------------------------------
# tokenizer tower
# ---------------------------------------------------------------------------


def test_whisper_encoder_matches_jax(pair):
    cfg, _, _, port, d = pair
    layer = cfg.audio_tower.encoder_target_hidden_layer
    ref = _apply(pair, lambda m, x: m.audio_tower.encoder(x, collect_layer=layer),
                 jnp.asarray(d["audio_features"]))
    with torch.no_grad():
        got = port.audio_tower.encoder(t(d["audio_features"]), collect_layer=layer)
    for key in ("last_hidden", "target_hidden"):
        assert rel_err(got[key].numpy(), ref[key]) <= REL, key


def test_whisper_decoder_split_kv_and_cached_match_jax(pair):
    cfg, _, _, port, _ = pair
    r = np.random.RandomState(7)
    c = cfg.audio_tower.whisper.d_model
    key_src = r.randn(2, 20, c).astype(np.float32)
    val_src = r.randn(2, 20, c).astype(np.float32)
    ids = r.randint(0, 900, (2, 6)).astype(np.int32)
    lens = np.array([6, 4], np.int32)
    ref, _ = _apply(pair, lambda m, *a: m.audio_tower.decoder(*a),
                    jnp.asarray(ids), jnp.asarray(key_src), jnp.asarray(val_src),
                    jnp.asarray(lens))
    dec = port.audio_tower.decoder
    with torch.no_grad():
        got, _ = dec(t(ids).long(), t(key_src), t(val_src), t(lens).long())
    assert rel_err(got.numpy(), ref) <= REL

    def jax_cached(m, ids, k, v):
        caches = m.audio_tower.decoder.init_cache(2, 8)
        h1, caches = m.audio_tower.decoder(ids[:, :5], k, v, caches=caches,
                                           cache_index=jnp.int32(0))
        h2, _ = m.audio_tower.decoder(ids[:, 5:], k, v, position_offset=5,
                                      caches=caches, cache_index=jnp.int32(5))
        return h1, h2
    ref1, ref2 = _apply(pair, jax_cached, jnp.asarray(ids), jnp.asarray(key_src),
                        jnp.asarray(val_src))
    with torch.no_grad():
        caches = dec.init_cache(2, 8)
        got1, caches = dec(t(ids[:, :5]).long(), t(key_src), t(val_src),
                           caches=caches, cache_index=0)
        got2, _ = dec(t(ids[:, 5:]).long(), t(key_src), t(val_src),
                      position_offset=5, caches=caches, cache_index=5)
    assert rel_err(got1.numpy(), ref1) <= REL
    assert rel_err(got2.numpy(), ref2) <= REL


def test_residual_vq_matches_jax(pair):
    cfg, _, _, port, _ = pair
    r = np.random.RandomState(8)
    feats = r.randn(2, 5, cfg.audio_tower.quantizer.dim).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]], bool)
    ref = _apply(pair, lambda m, x, k: m.audio_tower.vq(x, mask=k),
                 jnp.asarray(feats), jnp.asarray(mask))
    with torch.no_grad():
        got = port.audio_tower.vq.rvq(t(feats), mask=t(mask))
        out = codebook_output_from_indices(port.audio_tower.vq.rvq.codebook(),
                                           got["quantized_indices"])
    np.testing.assert_array_equal(got["quantized_indices"].numpy(),
                                  np.asarray(ref["quantized_indices"]))
    assert rel_err(got["quantized_feats"].numpy(), ref["quantized_feats"]) <= REL
    assert rel_err(got["commit_loss"].numpy(), ref["commit_loss"]) <= REL
    assert rel_err(out.numpy(), ref["quantized_feats"]) <= REL


def test_audio_tower_matches_jax(pair):
    _, _, _, port, d = pair
    args = [d[k] for k in ("audio_features", "asr_token_ids",
                           "asr_token_lengths", "asr_word_ids")]
    ref = _apply(pair, lambda m, *a: m.audio_tower(*a), *map(jnp.asarray, args))
    with torch.no_grad():
        got = port.audio_tower(t(args[0]), *(t(a).long() for a in args[1:]))
    np.testing.assert_array_equal(got["quantized_indices"].numpy(),
                                  np.asarray(ref["quantized_indices"]))
    assert rel_err(got["audio_unit_embeds"].numpy(), ref["audio_unit_embeds"]) <= REL


# ---------------------------------------------------------------------------
# speech decoder
# ---------------------------------------------------------------------------


def test_conformer_full_and_cached_decode_match_jax(pair):
    cfg, _, _, port, _ = pair
    sd = cfg.speech_decoder
    r = np.random.RandomState(9)
    x = r.randn(2, 7, sd.text_encoder.input_size).astype(np.float32)
    lens = np.array([7, 5], np.int32)
    ref = _apply(pair, lambda m, *a: m.speech_decoder.text_encoder(*a),
                 jnp.asarray(x), jnp.asarray(lens))
    with torch.no_grad():
        got = port.speech_decoder.text_encoder(t(x), t(lens).long())
    assert rel_err(got.numpy(), ref) <= REL

    xs = r.randn(2, 7, sd.llm.input_size).astype(np.float32)
    kv = np.ones((2, 12), bool)
    kv[1, :2] = False

    def jax_decode(m, xs, kv):
        llm = m.speech_decoder.llm
        pp = llm.precompute_pos_projs(12)
        caches = llm.init_cache(2, 12)
        kv = kv[:, None, None, :]
        h1, caches = llm.decode_step(xs[:, :5], caches, jnp.int32(0),
                                     key_valid=kv, pos_projs=pp)
        h2, caches = llm.decode_step(xs[:, 5:6], caches, jnp.int32(5),
                                     key_valid=kv, pos_projs=pp)
        h3, _ = llm.decode_step(xs[:, 6:], caches, jnp.int32(6), key_valid=kv)
        return h1, h2, h3
    refs = _apply(pair, jax_decode, jnp.asarray(xs), jnp.asarray(kv))
    llm = port.speech_decoder.llm
    with torch.no_grad():
        pp = llm.precompute_pos_projs(12)
        caches = llm.init_cache(2, 12)
        kvt = t(kv)[:, None, None, :]
        h1, caches = llm.decode_step(t(xs[:, :5]), caches, 0, key_valid=kvt,
                                     pos_projs=pp)
        h2, caches = llm.decode_step(t(xs[:, 5:6]), caches, 5, key_valid=kvt,
                                     pos_projs=pp)
        h3, _ = llm.decode_step(t(xs[:, 6:]), caches, 6, key_valid=kvt)
    for got_h, ref_h in zip((h1, h2, h3), refs):
        assert rel_err(got_h.numpy(), ref_h) <= REL


def test_speech_decoder_conditioning_and_greedy_generate_match_jax(pair):
    cfg, _, _, port, d = pair
    r = np.random.RandomState(10)
    units = r.randn(2, 8, cfg.speech_decoder.audio_encoder_input_size
                    ).astype(np.float32)
    args = (d["speaker_embeds"], units, d["asr_token_lengths"],
            d["asr_token_ids"], d["asr_token_lengths"])
    jargs = tuple(map(jnp.asarray, args))
    targs = (t(args[0]), t(args[1]), t(args[2]).long(), t(args[3]).long(),
             t(args[4]).long())
    ref = _apply(pair, lambda m, *a: m.speech_decoder.prepare_conditional_embeds(*a),
                 *jargs)
    with torch.no_grad():
        got = port.speech_decoder.prepare_conditional_embeds(*targs)
    for g, rf in zip(got, ref):
        assert rel_err(g.numpy(), rf) <= REL

    steps = 24
    ref = _apply(pair, lambda m, *a: m.speech_decoder.generate(
        jax.random.PRNGKey(0), *a, max_steps=steps, sampling_k=1),
        *jargs)
    got = port.speech_decoder.generate(*targs, max_steps=steps, sampling_k=1)
    np.testing.assert_array_equal(got["speech_token_ids"].numpy(),
                                  np.asarray(ref["speech_token_ids"]))
    np.testing.assert_array_equal(got["speech_token_lengths"].numpy(),
                                  np.asarray(ref["speech_token_lengths"]))


# ---------------------------------------------------------------------------
# voice generator
# ---------------------------------------------------------------------------


def test_flow_inference_with_injected_noise_matches_jax(pair):
    cfg, _, _, port, d = pair
    r = np.random.RandomState(11)
    tokens = r.randint(0, cfg.flow.vocab_size, (2, 12)).astype(np.int32)
    lens = np.array([12, 9], np.int32)
    mel_len_max = 40
    rng = jax.random.PRNGKey(12)
    ref_mel, ref_len = _apply(
        pair, lambda m, *a: m.voice_generator.flow.inference(rng, *a,
                                                             mel_len_max),
        jnp.asarray(tokens), jnp.asarray(lens),
        jnp.asarray(d["speaker_embeds"]))
    z = jax.random.normal(rng, (2, mel_len_max, cfg.flow.output_size))
    mel, mel_len = port.voice_generator.flow.inference(
        t(tokens).long(), t(lens).long(), t(d["speaker_embeds"]), mel_len_max,
        z=t(z))
    np.testing.assert_array_equal(mel_len.numpy(), np.asarray(ref_len))
    assert rel_err(mel.numpy(), ref_mel) <= REL


def test_hift_with_injected_noise_matches_jax(pair):
    cfg, _, _, port, _ = pair
    r = np.random.RandomState(13)
    mel = r.randn(2, 30, cfg.hift.in_channels).astype(np.float32)
    rng = jax.random.PRNGKey(14)
    ref = _apply(pair, lambda m, x, k: m.voice_generator.hift(x, k),
                 jnp.asarray(mel), rng)
    phase, noise = hift_noise(rng, 2, 30, cfg)
    with torch.no_grad():
        got = port.voice_generator.hift(t(mel), t(phase), t(noise))
    assert got.shape == ref.shape == (2, 30 * 64)
    # the f32 phase cumsum of the sine source drifts in another summation
    # order, hence abs 1e-3 on the clipped [-0.99, 0.99] waveform
    assert np.max(np.abs(got.numpy() - np.asarray(ref))) <= 1e-3


# ---------------------------------------------------------------------------
# the serving layout: fused DiT blocks and kernel convs, at the kernels' gates
# ---------------------------------------------------------------------------


def _counting(monkeypatch, module, name):
    """Wrap module.name so that calls through the module attribute count."""
    fn, calls = getattr(module, name), []

    def counted(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)
    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.fixture
def interpret_fused_dit(monkeypatch):
    monkeypatch.setenv("TASTE_FORCE_FUSED_DIT", "1")
    jax_fused_dit._INTERPRET[0] = True
    yield
    jax_fused_dit._INTERPRET[0] = False


def test_fused_dit_serving_estimator_matches_jax(interpret_fused_dit,
                                                  monkeypatch):
    """fused_dit_serving at C=128, the gate's width: every U-Net transformer
    block takes the fused block on both sides (the Pallas kernel in
    interpret mode in JAX; the kernel's plain version on the [in, out]
    weights prepared at load in the port), with ragged mel lengths."""
    over = dict(estimator_channels=(128, 128), estimator_num_heads=2,
                estimator_attention_head_dim=64, fused_dit_serving=True)
    jcfg = jax_config.FlowConfig.tiny().replace(**over)
    r = np.random.RandomState(15)
    b, tt, m = 2, 40, jcfg.output_size
    x, mu, cond = (r.randn(b, tt, m).astype(np.float32) for _ in range(3))
    spks = r.randn(b, m).astype(np.float32)
    ts = np.array([0.3, 0.7], np.float32)
    mask = np.arange(tt)[None, :] < np.array([40, 27])[:, None]
    args = (x, mask, mu, ts, spks, cond)
    est = jax_flow.ConditionalDecoder(jcfg)
    shapes = jax.eval_shape(est.init, jax.random.PRNGKey(0),
                            *map(jnp.asarray, args))
    params = random_params(shapes, r)
    jax_calls = _counting(monkeypatch, jax_fused_dit, "fused_dit_block")
    ref = jax.jit(est.apply)(jax.tree.map(jnp.asarray, params),
                             *map(jnp.asarray, args))

    port = port_flow.ConditionalDecoder(port_config.FlowConfig.tiny().replace(**over))
    port.load_state_dict(convert.to_torch(
        convert.estimator_state(params["params"], "")), strict=True)
    port_calls = _counting(monkeypatch, port_flow, "fused_dit_block")
    with torch.no_grad():
        got = port(*(t(a) for a in args))
    n_blocks = jcfg.estimator_n_blocks * (2 * len(over["estimator_channels"])
                                          + jcfg.estimator_num_mid_blocks)
    assert len(jax_calls) == len(port_calls) == n_blocks
    assert rel_err(got.numpy(), ref) <= REL


def test_pallas_conv_resblock_matches_jax(monkeypatch):
    """pallas_conv at the gate (channels 128, T >= 4096): every ResBlock conv
    takes conv1d_same on both sides (Pallas interpret in JAX; the kernel's
    plain version on the [K, Cin, Cout] weights prepared at load in the
    port), at two dilations."""
    r = np.random.RandomState(16)
    c, k, dils = 128, 7, (1, 3)
    x = (0.5 * r.randn(1, port_hift.KERNEL_MIN_T, c)).astype(np.float32)
    block = jax_hift.ResBlock(c, k, dils, use_pallas=True)
    params = random_params(jax.eval_shape(block.init, jax.random.PRNGKey(0),
                                          jnp.asarray(x)), r)
    jax_calls = _counting(monkeypatch, jax_conv1d, "conv1d_same")
    ref = jax.jit(block.apply)(jax.tree.map(jnp.asarray, params), jnp.asarray(x))

    sd = convert.collapse_weight_norm(convert.hift_state(
        {"source_resblocks_0": params["params"]}, prefix=""))
    port = port_hift.ResBlock(c, k, dils, use_kernel=True)
    port.load_state_dict(convert.to_torch(
        {key.removeprefix("source_resblocks.0."): v for key, v in sd.items()}),
        strict=True)
    port_calls = _counting(monkeypatch, port_hift, "conv1d_same")
    with torch.no_grad():
        got = port(t(x))
    assert len(jax_calls) == len(port_calls) == 2 * len(dils)
    assert rel_err(got.numpy(), ref) <= REL
