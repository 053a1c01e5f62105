"""TASLM, the earlier stage-2 spoken LM, of the PyTorch port against the
JAX package's TaslmForCausalLM, on the CPU at TaslmConfig.tiny(): the
forward's losses under each fusion with and without the speech LayerNorm,
single- and multi-channel speech, the latent sampling head on JAX's eps,
the RVQ-hidden reconstruction loss with the in-graph text KL (adapters
off), `calculate_log_likelihood`, and the KV-cached `generate` in the
continue, conditional and TTS modes with the eos and repetition stops,
the text forced after its terminate id, sampled on JAX's own Gumbel noise,
and the int8 serving layout's trajectory byte for byte.  Weights cross
through taste_spokenlm_tpu_torch.convert, strict.

Trajectories are held to the token only where no draw decides, or on
JAX's noise: greedy speech (`speech_use_greedy`) and a text top-p of 0
(mask_top_p keeps the top token), or TTS; the sampled case reads the
Gumbel noise of JAX's split chain (rng, r_text, r_speech = split(rng, 3)
per step) and the port's generator case is checked for repeatability.

Tolerances: f32 floats 1e-4 relative to the reference's max |value|;
ids and trajectories exact.  Wall: about 50 s on one worker
(python -m pytest tests/test_torch_taslm.py -q).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taste_spokenlm_tpu.models.quantizer import Codebook as JCb
from taste_spokenlm_tpu.models.taslm import TaslmConfig as JTaslmConfig
from taste_spokenlm_tpu.models.taslm import TaslmForCausalLM as JTaslm
from taste_spokenlm_tpu_torch import convert
from taste_spokenlm_tpu_torch.models.quantizer import Codebook
from taste_spokenlm_tpu_torch.models.taslm import (TaslmConfig,
                                                   TaslmForCausalLM)
from torch_parity_common import _fill_spoken_lm, rel_err, t

torch.set_num_threads(2)
TOL = 1e-4
IGNORE = -1
B, T = 2, 10


@functools.lru_cache(maxsize=1)
def _data():
    cfg = JTaslmConfig.tiny()
    r = np.random.RandomState(0)
    embed = r.randn(4, cfg.speech_vocab_size, 16).astype(np.float32)
    proj = (r.randn(16, cfg.speech_hidden_size) * 0.1).astype(np.float32)
    bias = (0.1 * r.randn(cfg.speech_hidden_size)).astype(np.float32)
    text = r.randint(2, cfg.llama.vocab_size, (B, T)).astype(np.int32)
    speech = r.randint(0, cfg.speech_vocab_size, (B, T, 4)).astype(np.int32)
    speech[:, 0, :] = cfg.speech_bos_id
    tl = np.where(np.arange(T)[None, :] < 8, text, IGNORE).astype(np.int32)
    sl = np.where(np.arange(T)[None, :, None] < 8, speech, IGNORE
                  ).astype(np.int32)
    return {"cb_j": JCb(jnp.asarray(embed), jnp.asarray(proj),
                        jnp.asarray(bias)),
            "cb_p": Codebook(t(embed), t(proj.T.copy()), t(bias)),
            "text": text, "speech": speech, "tl": tl, "sl": sl,
            "lens": np.array([T, 8], np.int32)}


def _pair(seed: int = 1, **kw):
    return _pair_cached(seed, tuple(sorted(kw.items())))


@functools.lru_cache(maxsize=None)
def _pair_cached(seed, kw):
    """(jax config, jax model, jax params, port model) for the tiny config
    with `kw` replaced; weights from `seed` at the spoken LM's scales.
    JAX's init sees labels, so the heads that only the losses call get
    their parameters."""
    kw = dict(kw)
    jcfg = JTaslmConfig.tiny().replace(**kw)
    d = _data()
    multi = jcfg.speech_num_channels > 1
    speech = d["speech"] if multi else d["speech"][..., 0]
    sl = d["sl"] if multi else d["sl"][..., :1]
    model = JTaslm(jcfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), d["cb_j"],
                            *map(jnp.asarray, (d["text"], speech, d["tl"],
                                               sl)))
    r = np.random.RandomState(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: _fill_spoken_lm(p, x, r), shapes["params"])
    port = TaslmForCausalLM(TaslmConfig.tiny().replace(**kw), device="cpu")
    port.load_state_dict(convert.to_torch(convert.taslm_state(params)),
                         strict=True)
    return jcfg, model, params, port.eval()


def _forward(model, params, *args, **kw):
    return jax.jit(lambda p, cb, *a: model.apply({"params": p}, cb, *a, **kw))(
        params, *args)


def _check_outputs(got, ref):
    for k, v in ref.items():
        g = got[k].detach().numpy()
        if np.ndim(v) == 0:
            assert abs(float(g) - float(v)) <= TOL * max(1.0, abs(float(v))), k
        else:
            assert rel_err(g, v) <= TOL, k


FORWARDS = [("addition", False), ("addition", True), ("gated", False),
            ("gated", True), ("weighted_sum", False), ("weighted_sum", True)]


@pytest.mark.parametrize("fusion,normalize", FORWARDS)
def test_forward_losses_match_jax(fusion, normalize):
    """Logits and every loss of the multi-channel head (per-channel decay
    0.9) on ragged attention lengths."""
    kw = dict(fusion_method=fusion, fusion_normalize_speech=normalize,
              speech_multi_channel_loss_decay_factor=0.9)
    _, model, params, port = _pair(**kw)
    d = _data()
    args = (d["text"], d["speech"], d["tl"], d["sl"], d["lens"])
    ref = _forward(model, params, d["cb_j"], *map(jnp.asarray, args))
    with torch.no_grad():
        got = port(d["cb_p"], *(t(a).long() for a in args))
    assert set(got) == set(ref)
    assert "speech_layer_3_ce_loss" in got
    _check_outputs(got, ref)


@pytest.mark.parametrize("variant", ["single_channel", "latent",
                                     "recon_and_kl"])
def test_forward_variants_match_jax(variant):
    """single_channel: one channel over V + 2 ids (bos / eos in the head).
    latent: the sampling head on JAX's eps (train, its gradient form
    too).  recon_and_kl: the RVQ-hidden reconstruction loss and the text
    KL to the adapter-disabled base computed in-graph (JAX masks it with
    the ignored positions, ~valid; the port mirrors it)."""
    kw = {"single_channel": dict(speech_num_channels=1),
          "latent": dict(speech_token_adopt_latent_sampling=True,
                         latent_dim=64),
          "recon_and_kl": dict(speech_labels_apply_quantization=True,
                               text_conduct_kl_loss=True)}[variant]
    jcfg, model, params, port = _pair(**kw)
    d = _data()
    speech, sl = d["speech"], d["sl"]
    if variant == "single_channel":
        speech, sl = speech[..., 0], sl[..., :1]
    args = (d["text"], speech, d["tl"], sl, d["lens"])
    jkw, pkw = {}, {}
    if variant == "latent":
        key = jax.random.PRNGKey(3)
        jkw = {"train": True, "rng": key}
        eps = jax.random.normal(key, (B, T, jcfg.latent_dim))
        pkw = {"train": True, "eps": t(eps)}
    if variant == "recon_and_kl":
        jkw = pkw = {"compute_ref_kl": True}
    ref = _forward(model, params, d["cb_j"], *map(jnp.asarray, args), **jkw)
    got = port(d["cb_p"], *(t(a).long() for a in args), **pkw)
    assert set(got) == set(ref)
    _check_outputs(got, ref)
    if variant == "recon_and_kl":
        assert float(got["text_kl_loss"].detach()) > 0
        assert "speech_recon_loss" in got
    if variant == "latent":
        got["loss"].backward()
        assert port.speech_latent_sampler.fc_mu.weight.grad.abs().sum() > 0


def test_calculate_log_likelihood_matches_jax():
    _, model, params, port = _pair()
    d = _data()
    args = (d["text"], d["speech"], d["tl"], d["sl"], np.array([T, T]))
    ref = _forward(model, params, d["cb_j"], *map(jnp.asarray, args),
                   method=JTaslm.calculate_log_likelihood)
    with torch.no_grad():
        got = port.calculate_log_likelihood(d["cb_p"],
                                            *(t(a).long() for a in args))
    assert set(got) == set(ref) and len(got) == 10
    _check_outputs(got, ref)


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

GREEDY = dict(speech_use_greedy=True, text_top_p=0.0)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _gumbel_chain(key, steps, v, c, h):
    """The text [steps, V] and speech [steps, C, H] Gumbel noise of each
    step of JAX's TASLM decode on `key`."""
    def body(k, _):
        k, r_text, r_speech = jax.random.split(k, 3)
        return k, (jax.random.gumbel(r_text, (v,), jnp.float32),
                   jax.random.gumbel(r_speech, (c, h), jnp.float32))
    return jax.lax.scan(body, key, None, length=steps)[1]


def _generate_both(model, params, port, cb, text, speech, text_len,
                   speech_len, max_steps, key=0, port_kw=None, **kw):
    ref = jax.jit(lambda p, c, a, b: model.apply(
        {"params": p}, jax.random.PRNGKey(key), c, a, b, jnp.int32(text_len),
        jnp.int32(speech_len), max_steps=max_steps, method=JTaslm.generate,
        **kw))(params, cb[0], jnp.asarray(text), jnp.asarray(speech))
    got = port.generate(cb[1], t(text).long(), t(speech).long(), text_len,
                        speech_len, max_steps=max_steps, **kw,
                        **(port_kw or {}))
    n = int(ref["num_steps"])
    assert got["num_steps"] == n
    np.testing.assert_array_equal(got["text_ids"].numpy(),
                                  np.asarray(ref["text_ids"]))
    np.testing.assert_array_equal(got["speech_ids"].numpy(),
                                  np.asarray(ref["speech_ids"]))
    return got, n


@pytest.mark.parametrize("mode", ["continue", "conditional_eos", "tts",
                                  "repetition", "terminate", "sampled"])
def test_generate_matches_jax(mode):
    """continue: speech length == text length, greedy.  conditional_eos:
    the surplus speech ids are forced, the third of them the speech eos,
    which stops the decode.  tts: single channel, the text forced from
    the prompt.  repetition: forced channel-0 ids that repeat stop the
    decode past one repeat.
    terminate: after the terminate id every later text id is it.
    sampled: text top-p 0.9 and speech top-p 0.3 on JAX's noise."""
    single = mode == "tts"
    jcfg, model, params, port = _pair(
        seed=2, **({"speech_num_channels": 1} if single else {}))
    d = _data()
    cb = (d["cb_j"], d["cb_p"])
    text, speech = d["text"][:1], d["speech"][:1]
    max_steps = 12
    if mode == "continue":
        got, n = _generate_both(model, params, port, cb, text, speech, 6, 6,
                                max_steps, **GREEDY)
        assert n == max_steps
    elif mode == "conditional_eos":
        speech = speech.copy()
        speech[0, 8, 0] = jcfg.speech_eos_id
        got, n = _generate_both(model, params, port, cb, text, speech, 6, 10,
                                max_steps, **GREEDY)
        assert n == 3
        np.testing.assert_array_equal(got["speech_ids"][:3].numpy(),
                                      speech[0, 6:9])
    elif mode == "tts":
        speech = np.full((1, 1), jcfg.speech_bos_id, np.int32)
        got, n = _generate_both(model, params, port, cb, text, speech, T, 1,
                                max_steps, is_tts=True, speech_use_greedy=True)
        np.testing.assert_array_equal(got["text_ids"][:min(n, T - 1)].numpy(),
                                      text[0, 1:1 + min(n, T - 1)])
    elif mode == "repetition":
        speech = speech.copy()
        speech[0, 6:10, 0] = 7
        got, n = _generate_both(model, params, port, cb, text, speech, 6, 10,
                                max_steps, speech_repetition_max=1, **GREEDY)
        assert n == 3 and got["speech_ids"][:3, 0].tolist() == [7, 7, 7]
    elif mode == "terminate":
        first = port.generate(d["cb_p"], t(text).long(), t(speech).long(), 6,
                              6, max_steps=max_steps, **GREEDY)["text_ids"]
        stop = int(first[1])
        got, n = _generate_both(model, params, port, cb, text, speech, 6, 6,
                                max_steps, text_terminate_id=stop, **GREEDY)
        assert (got["text_ids"][1:n] == stop).all()
    else:
        text_g, speech_g = _gumbel_chain(
            jax.random.PRNGKey(5), max_steps, jcfg.llama.vocab_size, 4,
            jcfg.speech_vocab_size)
        got, n = _generate_both(
            model, params, port, cb, text, speech, 6, 6, max_steps, key=5,
            port_kw={"text_gumbel": t(text_g), "speech_gumbel": t(speech_g)})
        # the draws decided: the greedy trajectory differs
        greedy = port.generate(d["cb_p"], t(text).long(), t(speech).long(), 6,
                               6, max_steps=max_steps, **GREEDY)
        assert not torch.equal(greedy["speech_ids"], got["speech_ids"])
        # the port's own generator: the same trajectory from the same state
        runs = [port.generate(d["cb_p"], t(text).long(), t(speech).long(), 6,
                              6, max_steps=max_steps,
                              generator=torch.Generator().manual_seed(9))
                for _ in range(2)]
        for k in ("text_ids", "speech_ids"):
            assert torch.equal(runs[0][k], runs[1][k])


def test_int8_layout_trajectory_matches_jax():
    """The int8 serving layout (merged LoRA; int8 projections, fused qkv
    and MLP, an int8 table with the int4 tied head): JAX's quantizer on
    JAX's tree, crossed by convert.py, equals the port's quantizer on the
    port's float weights byte for byte, and the greedy trajectory matches
    JAX's."""
    from taste_spokenlm_tpu.utils.quant import (merge_lora_params,
                                                quantize_llama_params)
    from taste_spokenlm_tpu_torch import quant
    jcfg, _, params, port = _pair(seed=2)
    lora = jcfg.lora
    qtree = jax.tree.map(np.asarray, quantize_llama_params(
        merge_lora_params(params["language_model"], lora.alpha, lora.r),
        include_embed=True, mode="int8", embed_head_mode="int4",
        fuse_qkv=True, fused_mlp=True))
    qparams = dict(params, language_model=qtree)
    llama_kw = dict(quantized_serving="int8",
                    quantized_embed_serving="int4head",
                    fused_qkv_serving=True, fused_mlp_serving=True)
    qcfg = jcfg.replace(use_lora=False, llama=jcfg.llama.replace(**llama_kw))
    pcfg = TaslmConfig.tiny().replace(
        use_lora=False, llama=TaslmConfig.tiny().llama.replace(**llama_kw))
    qport = TaslmForCausalLM(pcfg, device="cpu")
    sd = convert.to_torch(convert.taslm_state(qparams))
    qport.load_state_dict(sd, strict=True)
    qport.eval()
    lm_sd = {k[len("language_model."):]: v for k, v in
             port.state_dict().items() if k.startswith("language_model.")}
    mine = quant.quantize_llama_params(
        quant.merge_lora_params(lm_sd, lora.alpha, lora.r), include_embed=True,
        mode="int8", embed_head_mode="int4", fuse_qkv=True, fused_mlp=True)
    for k, v in mine.items():
        want = sd[f"language_model.{k}"]
        assert v.dtype == want.dtype, k
        if v.dtype in (torch.int8, torch.uint8):
            assert torch.equal(v, want), k
        else:
            assert rel_err(v.numpy(), want.numpy()) <= 1e-6, k
    d = _data()
    model = JTaslm(qcfg)
    got, n = _generate_both(model, qparams, qport, (d["cb_j"], d["cb_p"]),
                            d["text"][:1], d["speech"][:1], 6, 6, 12, **GREEDY)
    assert n == 12
