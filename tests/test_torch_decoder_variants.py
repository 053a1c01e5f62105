"""The speech decoder's fusions and the audio tower's variants of the
PyTorch port against the JAX package, on the CPU: the concat and
concat_with_sep fusions (the teacher-forced loss and logits, the greedy
KV-cached decode over the 2T (+ 1) long packed prefix) and fuse_normalize;
the legacy alignment-pooling tower and the add_and_norm tower.  Weights
cross through taste_spokenlm_tpu_torch.convert, strict.

Tolerances: f32 floats 1e-4 relative to the reference's max |value|; ids,
RVQ indices and trajectories exact.  Wall: about 20 s on one worker
(python -m pytest tests/test_torch_decoder_variants.py -q).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taste_spokenlm_tpu_torch import convert
from torch_parity_common import fill_params, jit_apply, rel_err, t

torch.set_num_threads(2)
TOL = 1e-4


# ---------------------------------------------------------------------------
# the speech decoder's fusions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fuse", ["concat", "concat_with_sep",
                                  "weighted_sum_normalize"])
def test_speech_decoder_fusion_matches_jax(fuse):
    """The teacher-forced loss and logits, and under the concat fusions the
    greedy (top-1) KV-cached decode, whose packed prefix is 2T (+ 1)
    long."""
    from taste_spokenlm_tpu.config import SpeechDecoderConfig as JS
    from taste_spokenlm_tpu.models.speech_decoder import TasteSpeechDecoder as JD
    from taste_spokenlm_tpu_torch.config import SpeechDecoderConfig
    from taste_spokenlm_tpu_torch.models.speech_decoder import TasteSpeechDecoder
    kw = ({"fuse_normalize": True} if fuse == "weighted_sum_normalize"
          else {"fuse_type": fuse})
    jcfg, pcfg = JS.tiny().replace(**kw), SpeechDecoderConfig.tiny().replace(**kw)
    r = np.random.RandomState(10)
    b, tt, s = 2, 6, 7
    args = (r.randn(b, jcfg.spk_embed_dim).astype(np.float32),
            r.randn(b, tt, jcfg.audio_encoder_input_size).astype(np.float32),
            np.array([6, 4], np.int32),
            r.randint(0, jcfg.text_token_size, (b, tt)).astype(np.int32),
            np.array([6, 4], np.int32),
            r.randint(0, jcfg.speech_token_size, (b, s)).astype(np.int32),
            np.array([7, 5], np.int32))
    jmod = JD(jcfg)
    jargs = tuple(map(jnp.asarray, args))
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *jargs)
    params = fill_params(shapes["params"], 11)
    port = TasteSpeechDecoder(pcfg)
    port.load_state_dict(convert.to_torch(convert.speech_decoder_state(
        params, "")), strict=True)
    port.eval()
    ref = jit_apply(jmod, {"params": params}, *jargs)
    pargs = tuple(t(a) if a.dtype == np.float32 else t(a).long() for a in args)
    with torch.no_grad():
        got = port(*pargs)
    extra = {"concat": 0, "concat_with_sep": 1}.get(fuse)
    if extra is not None:
        assert got["logits"].shape[1] == 3 + 2 * tt + extra + s
    assert rel_err(got["logits"].numpy(), ref["logits"]) <= TOL
    assert abs(float(got["loss"]) - float(ref["loss"])) <= TOL * float(ref["loss"])
    if extra is None:
        return
    gen = jit_apply(jmod, {"params": params}, jax.random.PRNGKey(1), *jargs[:5],
                  max_steps=10, sampling_k=1, method=JD.generate)
    out = port.generate(*pargs[:5], max_steps=10, sampling_k=1)
    np.testing.assert_array_equal(out["speech_token_ids"].numpy(),
                                  np.asarray(gen["speech_token_ids"]))
    np.testing.assert_array_equal(out["speech_token_lengths"].numpy(),
                                  np.asarray(gen["speech_token_lengths"]))


# ---------------------------------------------------------------------------
# the audio tower: legacy segmenter, add_and_norm
# ---------------------------------------------------------------------------


def _tower_quantizer(shapes, r):
    def fill(path, leaf):
        name = str(path[-1].key)
        if name == "initted":
            return np.ones(leaf.shape, bool)
        if name == "cluster_size":
            return np.ones(leaf.shape, np.float32)
        return (0.5 * r.randn(*leaf.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("variant", ["legacy", "add_and_norm"])
def test_audio_tower_variant_matches_jax(variant):
    """legacy: alignment pooling of the middle layer's hidden, the affine
    map and the RVQ against JAX's tower (embeds, indices).  add_and_norm:
    JAX's tower raises on it (flax's AssignSubModuleError: a LayerNorm made
    outside setup), so the port's decoder features are held against JAX's
    own encoder and decoder composed as the option says, cross-attention
    keys and values LayerNorm(final + middle hidden)."""
    from taste_spokenlm_tpu.config import AudioTowerConfig as JT
    from taste_spokenlm_tpu.models.audio_tower import TasteAudioTower as JA
    from taste_spokenlm_tpu_torch.config import AudioTowerConfig
    from taste_spokenlm_tpu_torch.models.audio_tower import TasteAudioTower
    r = np.random.RandomState(12)
    jcfg, pcfg = JT.tiny(), AudioTowerConfig.tiny()
    if variant == "legacy":
        kw = dict(is_joint_encoder_segmenter=False, encoder_input_size=32)
        jcfg = jcfg.replace(**kw, quantizer=jcfg.quantizer.replace(dim=32))
        pcfg = pcfg.replace(**kw, quantizer=pcfg.quantizer.replace(dim=32))
    w = jcfg.whisper
    mel = r.randn(2, w.n_mels, 192).astype(np.float32)
    ids = r.randint(10, w.vocab_size, (2, 5)).astype(np.int32)
    lens = np.array([5, 3], np.int32)
    al = np.sort(r.rand(2, 5, 2), axis=-1).astype(np.float32)
    mel_lens = np.array([192, 150], np.int32)
    jmod = JA(jcfg)
    jkw = ({"asr_token_alignments": jnp.asarray(al),
            "mel_lengths": jnp.asarray(mel_lens)} if variant == "legacy" else {})
    shapes = jax.eval_shape(functools.partial(jmod.init, **jkw),
                            jax.random.PRNGKey(0), jnp.asarray(mel),
                            jnp.asarray(ids), jnp.asarray(lens), None)
    params = fill_params(shapes["params"], 13)
    quant = _tower_quantizer(shapes["quantizer"], r)
    variables = {"params": params, "quantizer": quant}
    if variant == "add_and_norm":
        pcfg = pcfg.replace(fuse_forward_type="add_and_norm")
        ln = {"scale": (1 + 0.1 * r.randn(w.d_model)).astype(np.float32),
              "bias": (0.1 * r.randn(w.d_model)).astype(np.float32)}
        params = dict(params, early_exit_layer_norm=ln)
    port = TasteAudioTower(pcfg)
    port.load_state_dict(convert.to_torch(convert.audio_tower_state(
        params, quant["vq"], "")), strict=True)
    port.eval()
    if variant == "legacy":
        ref = jit_apply(jmod, variables, jnp.asarray(mel), jnp.asarray(ids),
                      jnp.asarray(lens), None, jkw["asr_token_alignments"],
                      jkw["mel_lengths"], method=lambda m, *a: m(
                          *a[:4], asr_token_alignments=a[4], mel_lengths=a[5]))
        with torch.no_grad():
            got = port(t(mel), t(ids).long(), t(lens).long(),
                       asr_token_alignments=t(al), mel_lengths=t(mel_lens))
        np.testing.assert_array_equal(got["quantized_indices"].numpy(),
                                      np.asarray(ref["quantized_indices"]))
        assert rel_err(got["audio_unit_embeds"].numpy(),
                       ref["audio_unit_embeds"]) <= TOL
        return

    def feats(m, mel_, ids_, lens_):
        enc = m.encoder(mel_, collect_layer=jcfg.encoder_target_hidden_layer)
        x = enc["last_hidden"] + enc["target_hidden"]
        mu = x.mean(-1, keepdims=True)
        x = (x - mu) * jax.lax.rsqrt(((x - mu) ** 2).mean(-1, keepdims=True)
                                     + 1e-5) * ln["scale"] + ln["bias"]
        n = len(w.decoder_prompt)
        tokens = jnp.concatenate(
            [jnp.tile(jnp.asarray(w.decoder_prompt)[None], (2, 1)), ids_,
             jnp.full((2, 1), w.eos_token_id)], axis=1)
        dec, _ = m.decoder(tokens, x, x, input_lengths=lens_ + n + 1)
        return dec[:, n:-1]
    ref = jit_apply(jmod, variables, jnp.asarray(mel), jnp.asarray(ids),
                  jnp.asarray(lens), method=feats)
    with torch.no_grad():
        got = port._segment(t(mel), t(ids).long(), t(lens).long(), None)
        full = port(t(mel), t(ids).long(), t(lens).long())
    assert rel_err(got.numpy(), ref) <= TOL
    assert full["quantized_indices"].shape == (2, 5, jcfg.quantizer.num_quantizers)
