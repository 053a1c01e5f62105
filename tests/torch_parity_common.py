"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py).

One tiny TasteForCausalLM on each side: the JAX reference, with weights
filled from a numpy seed, and the port, loaded from the same weights
through taste_spokenlm_tpu_torch.convert with strict=True.  Inputs and
noise are numpy arrays handed to both.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from taste_spokenlm_tpu.config import TasteConfig as JaxTasteConfig
from taste_spokenlm_tpu.models.taste import TasteForCausalLM as JaxTaste
from taste_spokenlm_tpu_torch import convert
from taste_spokenlm_tpu_torch.config import TasteConfig
from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM


def inputs(cfg, seed: int = 0):
    """A batch of two utterances with ragged asr lengths and word runs."""
    r = np.random.RandomState(seed)
    b, t = 2, 8
    w = cfg.audio_tower.whisper
    return {
        "speaker_embeds": r.randn(b, cfg.speech_decoder.spk_embed_dim
                                  ).astype(np.float32),
        "asr_token_ids": r.randint(10, w.vocab_size, (b, t)).astype(np.int32),
        "asr_token_lengths": np.array([8, 6], np.int32),
        "asr_word_ids": np.array([[0, 0, 1, 1, 2, 3, 3, 4],
                                  [0, 1, 1, 2, 3, 3, 0, 0]], np.int32),
        "audio_features": r.randn(b, w.n_mels, 2 * w.max_source_positions
                                  ).astype(np.float32),
    }


def _fill(path, leaf, r):
    """Weights at scales that keep every activation O(1): norms near 1,
    fan-in scaled kernels, codebooks on the scale of their inputs."""
    name = str(getattr(path[-1], "key", path[-1]))
    shape, dtype = leaf.shape, leaf.dtype
    if dtype == jnp.bool_:
        return np.ones(shape, bool)
    if name == "scale" or name.startswith("alpha") or name == "fuse_weights":
        return (1.0 + 0.1 * r.randn(*shape)).astype(np.float32)
    if name in ("bias", "pos_bias_u", "pos_bias_v"):
        return (0.1 * r.randn(*shape)).astype(np.float32)
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        return (r.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
    if name == "cluster_size":
        return np.ones(shape, np.float32)
    return r.randn(*shape).astype(np.float32)


def random_params(shapes, r):
    """numpy weights for a tree of jax.ShapeDtypeStruct, filled as _fill
    does."""
    return jax.tree_util.tree_map_with_path(lambda p, x: _fill(p, x, r), shapes)


@functools.lru_cache(maxsize=1)
def tiny_pair(seed: int = 0):
    """(jax config, jax model, jax variables, port model) at
    TasteConfig.tiny(), float32, on the CPU.  The spoken LM (float, with
    LoRA adapters) is filled from its own seed after the rest, so the
    reconstruction weights do not depend on it."""
    cfg = JaxTasteConfig.tiny()
    model = JaxTaste(cfg)
    d = {k: jnp.asarray(v) for k, v in inputs(cfg).items()}
    shapes = jax.eval_shape(
        functools.partial(model.init, method=JaxTaste.init_reconstruction),
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), d["speaker_embeds"],
        d["asr_token_ids"], d["asr_token_lengths"], d["asr_word_ids"],
        d["audio_features"])
    variables_np = random_params(shapes, np.random.RandomState(seed))
    # the HiFT f0 head lands in the voiced range, so the sine path runs
    f0 = variables_np["params"]["voice_generator"]["hift"]["f0_predictor"]
    f0["classifier"]["bias"] = np.full_like(f0["classifier"]["bias"], 150.0)
    # and the magnitude head stays below its exp clamp, so the waveform is
    # not mostly clipped
    post = variables_np["params"]["voice_generator"]["hift"]["conv_post"]
    post["kernel"] = post["kernel"] * np.float32(0.2)
    lm = {k: jnp.asarray(v) for k, v in lm_inputs(cfg).items()}
    all_shapes = jax.eval_shape(
        functools.partial(model.init, method=JaxTaste.init_all),
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), d["speaker_embeds"],
        d["asr_token_ids"], d["asr_token_lengths"], d["asr_word_ids"],
        d["audio_features"], jnp.zeros((2, 4), jnp.int32),
        jnp.full((2,), 4, jnp.int32), lm["llm_token_ids"],
        lm["llm_token_lengths"], lm["llm_word_ids"])
    r = np.random.RandomState(seed + 100)
    variables_np["params"]["spoken_lm"] = jax.tree_util.tree_map_with_path(
        lambda p, x: _fill_spoken_lm(p, x, r), all_shapes["params"]["spoken_lm"])
    variables = jax.tree.map(jnp.asarray, variables_np)
    return cfg, model, variables, port_model(TasteConfig.tiny(), variables_np)


def voice_noise(rng, batch: int, mel_len_max: int, cfg):
    """The random draws of the JAX VoiceGenerator for `rng`, by the same
    split chain (generator.py, flow.py ConditionalCFM, hift.py
    HiFTGenerator + sine_source): (z, source phase, source noise)."""
    rng_flow, rng_hift = jax.random.split(rng)
    z = jax.random.normal(rng_flow, (batch, mel_len_max, cfg.flow.output_size),
                          jnp.float32)
    phase, noise = hift_noise(rng_hift, batch, mel_len_max, cfg)
    return np.asarray(z), phase, noise


def hift_noise(rng, batch: int, n_frames: int, cfg):
    h = cfg.hift
    n_samples = n_frames * int(np.prod(h.upsample_rates)) * h.istft_hop_len
    rng_src, _ = jax.random.split(rng)
    rng_phase, rng_noise = jax.random.split(rng_src)
    phase = jax.random.uniform(rng_phase, (batch, h.nb_harmonics + 1, 1),
                               minval=-jnp.pi, maxval=jnp.pi)
    noise = jax.random.normal(rng_noise, (batch, h.nb_harmonics + 1, n_samples))
    return np.asarray(phase), np.asarray(noise)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _s3_gumbel(key, steps, b, v1):
    """The gumbel noise of each step of the JAX S3 decode on `key`."""
    def body(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.gumbel(sub, (b, v1), jnp.float32)
    return jax.lax.scan(body, key, None, length=steps)[1]


def s3_gumbel(cfg, key, steps, b=1):
    return t(_s3_gumbel(key, steps, b, cfg.speech_decoder.speech_token_size + 1))


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _jd_gumbel_jax(key, steps, v, l, k):
    """The text [steps, V] and taste [steps, L, K] gumbel noise of each
    step of JAX's joint decode on `key` (one row): the step key from the
    split chain, folded with the row, split into text and taste keys, as
    jax.random.categorical draws them."""
    def body(c, _):
        c, sub = jax.random.split(c)
        k_text, k_taste = jax.random.split(jax.random.fold_in(sub, 0))
        return c, (jax.random.gumbel(k_text, (v,), jnp.float32),
                   jax.random.gumbel(k_taste, (l, k), jnp.float32))
    return jax.lax.scan(body, key, None, length=steps)[1]


def jd_draws_jax(cfg, rng_jd, steps):
    """The port's joint-decode `draws` for JAX's decode key `rng_jd`."""
    q = cfg.audio_tower.quantizer
    text, taste = _jd_gumbel_jax(rng_jd, steps, cfg.spoken_lm.llama.vocab_size,
                                 q.num_quantizers, q.codebook_size)
    return {"text_gumbel": t(text)[:, None],
            "taste_gumbel": t(taste)[:, None]}


def t(x, dtype=None):
    """numpy / jax array -> CPU torch tensor."""
    a = torch.from_numpy(np.array(x))
    return a if dtype is None else a.to(dtype)


def rel_err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-12))


# ---------------------------------------------------------------------------
# the completion slice: the spoken LM in the float and the serving layouts
# ---------------------------------------------------------------------------


def serving_config(cfg, mode: str = "int8", fused_mlp: bool = True):
    """A serving layout of a TasteConfig (either package's), as bench.py
    builds it: merged LoRA, the Llama in `mode` ("int8" / "int4") with the
    int4 tied head and fused qkv, the S3 llm stack likewise; `fused_mlp`
    the fused MLPs (BENCH_FUSED_MLP=1), else gate / up as one gateup_proj."""
    sd, lm = cfg.speech_decoder, cfg.spoken_lm
    return cfg.replace(
        spoken_lm=lm.replace(use_lora=False, llama=lm.llama.replace(
            quantized_serving=mode, quantized_embed_serving="int4head",
            fused_qkv_serving=True, fused_mlp_serving=fused_mlp)),
        speech_decoder=sd.replace(llm=sd.llm.replace(
            quantized_serving=mode, fused_qkv_serving=True,
            fused_mlp_serving=fused_mlp)))


def lm_inputs(cfg, seed: int = 1):
    """A spoken-LM prefix of two rows: llm ids, ragged lengths, word runs
    and the taste indices at word starts (-1 elsewhere)."""
    r = np.random.RandomState(seed)
    q = cfg.audio_tower.quantizer
    word_ids = np.array([[0, 0, 1, 2, 2, 3, 4, 4, 5],
                         [0, 1, 1, 2, 3, 4, 4, 0, 0]], np.int32)
    lengths = np.array([9, 7], np.int32)
    ids = r.randint(2, cfg.spoken_lm.llama.vocab_size, word_ids.shape)
    indices = np.full(word_ids.shape + (q.num_quantizers,), -1, np.int32)
    for bi in range(2):
        for ti in range(lengths[bi]):
            if ti == 0 or word_ids[bi, ti] != word_ids[bi, ti - 1]:
                indices[bi, ti] = r.randint(0, q.codebook_size, q.num_quantizers)
    return {"llm_indices": indices, "llm_token_ids": ids.astype(np.int32),
            "llm_token_lengths": lengths, "llm_word_ids": word_ids}


class VocabScan:
    """A deterministic id -> subword map standing in for the Llama
    tokenizer when building the sampler tables (as bench.py's)."""

    def decode(self, i):
        return (" the", "ing", ".", " end.", "!!", "a\nb", " word", "s",
                ",'", " no.", "xyz")[i % 11]


def _fill_spoken_lm(path, leaf, r):
    """Weights of the spoken LM: norms near 1, fan-in scaled kernels, small
    LoRA adapters (so merging moves the weights a little)."""
    name = str(getattr(path[-1], "key", path[-1]))
    shape = leaf.shape
    if name == "weight":                     # RMSNorm
        return (1.0 + 0.1 * r.randn(*shape)).astype(np.float32)
    if name == "kernel":
        return (r.randn(*shape) / np.sqrt(shape[0])).astype(np.float32)
    if name in ("lora_a", "lora_b"):
        return (0.1 * r.randn(*shape) / np.sqrt(shape[0])).astype(np.float32)
    if name == "bias":
        return (0.1 * r.randn(*shape)).astype(np.float32)
    return r.randn(*shape).astype(np.float32)


def quantize_variables_jax(cfg, variables, mode: str = "int8",
                           fused_mlp: bool = True):
    """The serving tree of serving_config(cfg, mode, fused_mlp) by the JAX
    package's own quantizer, from the float variables (numpy leaves)."""
    from taste_spokenlm_tpu.utils.quant import (_quantize_dense_leaf,
                                                merge_lora_params,
                                                quantize_encoder_params,
                                                quantize_llama_params)
    lora = cfg.spoken_lm.lora
    params = dict(variables["params"])
    slm = dict(params["spoken_lm"])
    lm = merge_lora_params(slm["language_model"], lora.alpha, lora.r)
    slm["language_model"] = jax.tree.map(np.asarray, quantize_llama_params(
        lm, include_embed=True, mode=mode, embed_head_mode="int4",
        fuse_qkv=True, fused_mlp=fused_mlp))
    sdec = dict(params["speech_decoder"])
    sdec["llm"] = jax.tree.map(np.asarray, quantize_encoder_params(
        sdec["llm"], mode=mode, fuse_qkv=True, fused_mlp=fused_mlp))
    sdec["llm_decoder"] = jax.tree.map(
        np.asarray, _quantize_dense_leaf(sdec["llm_decoder"], mode))
    params.update(spoken_lm=slm, speech_decoder=sdec)
    return dict(variables, params=params)


def port_model(cfg, variables, dtype=torch.float32):
    port = TasteForCausalLM(cfg, dtype=dtype, device="cpu")
    port.load_state_dict(convert.to_torch(convert.params_to_state_dict(variables)),
                         strict=True)
    return port.eval()
