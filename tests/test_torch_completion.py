"""The port's completion slice (joint text + taste decode -> S3 -> mel ->
wav) against the same composition in JAX at TasteConfig.tiny(), float32 on
the CPU, in the float layout (LoRA adapters) and in three serving layouts
(merged LoRA, the int4 tied head, fused qkv, the S3 llm stack quantized as
the Llama): "int8" (int8 with fused MLPs), "int4_fused" (int4 with fused
MLPs, bench.py's BENCH_QUANT=4 BENCH_FUSED_MLP=1) and "int4" (int4 with a
gateup_proj, BENCH_FUSED_MLP=0), all from the JAX package's weights through
taste_spokenlm_tpu_torch.convert (strict=True).

generate_completion runs greedy (text_top_p 0, taste_top_p 0), the S3
decode greedy (sampling_k 1), and the voice generator takes the JAX split
chain's noise.  The text, word, taste and S3 trajectories must be equal
exactly, the waveform within 1e-3 absolute (the sine source's f32 phase
cumsum runs in another summation order).  In the serving layouts the JAX
side runs its Pallas kernels in interpret mode, and a spy on the port's
plain kernel versions shows which kernel branches ran.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taste_spokenlm_tpu.models.sampler import SamplerConfig as JaxSamplerConfig
from taste_spokenlm_tpu.models.sampler import build_sampler_tables
from taste_spokenlm_tpu.models.taste import TasteForCausalLM as JaxTaste
from taste_spokenlm_tpu_torch import convert, quant
from taste_spokenlm_tpu_torch.config import TasteConfig
from taste_spokenlm_tpu_torch.kernels import fused_mlp, int4_matmul
from taste_spokenlm_tpu_torch.models.llama import LlamaModel
from taste_spokenlm_tpu_torch.models.sampler import SamplerConfig

from torch_parity_common import (VocabScan, inputs, lm_inputs, port_model,
                                 quantize_variables_jax, rel_err,
                                 serving_config, t, tiny_pair, voice_noise)

torch.set_num_threads(2)
MAX_STEPS, MAX_SPEECH, MEL_LEN_MAX, ASR_LEN = 16, 24, 48, 10
SAMPLER = dict(delay=1, delay_level="word", text_top_p=0.0, taste_top_p=0.0,
               extra_words=4, has_prefix=True)


def _float_variables():
    return jax.tree.map(np.asarray, tiny_pair()[2])


# serving layout -> (quantized_serving, fused_mlp_serving)
LAYOUTS = {"int8": ("int8", True), "int4_fused": ("int4", True),
           "int4": ("int4", False)}


@functools.lru_cache(maxsize=None)
def _pair(layout: str):
    if layout == "float":
        return tiny_pair()
    mode, fused = LAYOUTS[layout]
    jcfg = serving_config(tiny_pair()[0], mode, fused)
    variables = quantize_variables_jax(jcfg, _float_variables(), mode, fused)
    return jcfg, JaxTaste(jcfg), jax.tree.map(jnp.asarray, variables), \
        port_model(serving_config(TasteConfig.tiny(), mode, fused), variables)


def _spy(monkeypatch):
    """Counts of the port's plain kernel versions (what its wrappers run on
    the CPU)."""
    calls = {}
    for mod, name in ((fused_mlp, "gated_mlp_int8_plain"),
                      (fused_mlp, "ffn_int8_plain"),
                      (fused_mlp, "gated_mlp_int4_plain"),
                      (fused_mlp, "ffn_int4_plain"),
                      (int4_matmul, "matmul_int4_plain")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("layout", ["float", "int8", "int4_fused", "int4"])
def test_completion_and_synthesis_match_jax(monkeypatch, layout):
    jcfg, model, variables, port = _pair(layout)
    calls = _spy(monkeypatch)
    v = jcfg.spoken_lm.llama.vocab_size
    tables_np = build_sampler_tables(VocabScan(), v)
    # a prefix on which the int4 layouts' greedy text crosses word starts
    # (from the default one it repeats one subword)
    int4 = layout.startswith("int4")
    lm = lm_inputs(jcfg, 8 if int4 else 1)

    out_j = jax.jit(lambda var, *a: model.apply(
        var, jax.random.PRNGKey(0), JaxSamplerConfig(**SAMPLER),
        {k: jnp.asarray(x) for k, x in tables_np.items()}, *a, "audio",
        MAX_STEPS, method=JaxTaste.generate_completion))(
            variables, *(jnp.asarray(lm[k]) for k in (
                "llm_indices", "llm_token_ids", "llm_token_lengths",
                "llm_word_ids")))
    out_p = port.generate_completion(
        SamplerConfig(**SAMPLER), {k: torch.from_numpy(x)
                                   for k, x in tables_np.items()},
        *(t(lm[k]).long() for k in ("llm_indices", "llm_token_ids",
                                    "llm_token_lengths", "llm_word_ids")),
        max_steps=MAX_STEPS)
    for key in ("llm_token_ids", "llm_word_ids", "taste_indices",
                "num_tokens", "num_taste_words"):
        np.testing.assert_array_equal(out_p[key].numpy(), np.asarray(out_j[key]),
                                      err_msg=key)
    n_taste = out_p["num_taste_words"].numpy()
    assert (n_taste >= 2).all() and (out_p["num_tokens"].numpy() >= 2).all()
    # stopped early: the sampler's countdown ended the decode (the int4
    # layouts' random-weight text runs to max_steps)
    assert int(out_p["steps"]) < MAX_STEPS or int4

    # host glue as bench.py: dense per-word taste, asr tokens 2 per word
    q = jcfg.audio_tower.quantizer
    taste = np.zeros((2, MAX_STEPS, q.num_quantizers), np.int32)
    for bi in range(2):
        taste[bi, :n_taste[bi]] = np.maximum(
            out_p["taste_indices"].numpy()[bi, :n_taste[bi]], 0)
    d = inputs(jcfg)
    r = np.random.RandomState(7)
    asr_ids = r.randint(10, jcfg.audio_tower.whisper.vocab_size,
                        (2, ASR_LEN)).astype(np.int32)
    asr_lens = np.array([ASR_LEN, ASR_LEN - 3], np.int32)
    asr_words = np.minimum(np.arange(ASR_LEN) // 2, n_taste.min() - 1
                           )[None].repeat(2, 0).astype(np.int32)
    rng = jax.random.PRNGKey(3)
    syn_args = (d["speaker_embeds"], taste, asr_ids, asr_lens, asr_words)
    syn_j = jax.jit(lambda var, *a: model.apply(
        var, rng, *a, max_speech_steps=MAX_SPEECH, mel_len_max=MEL_LEN_MAX,
        sampling_k=1, method=JaxTaste.synthesize_from_taste))(
            variables, *map(jnp.asarray, syn_args))
    z, phase, noise = voice_noise(jax.random.split(rng)[1], 2, MEL_LEN_MAX, jcfg)
    syn_p = port.synthesize_from_taste(
        t(syn_args[0]), *(t(a).long() for a in syn_args[1:]),
        max_speech_steps=MAX_SPEECH, mel_len_max=MEL_LEN_MAX, sampling_k=1,
        z=t(z), source_phase=t(phase), source_noise=t(noise))
    for key in ("speech_token_ids", "speech_token_lengths", "waveform_lengths"):
        np.testing.assert_array_equal(syn_p[key].numpy(), np.asarray(syn_j[key]),
                                      err_msg=key)
    assert (syn_p["speech_token_lengths"].numpy() > 0).all()
    wav_p, wav_j = syn_p["waveform"].numpy(), np.asarray(syn_j["waveform"])
    assert np.isfinite(wav_p).all() and np.abs(wav_p).max() > 1e-4
    assert np.max(np.abs(wav_p - wav_j)) <= 1e-3

    # the fused MLPs and the int4 products ran (no width gate: tiny sizes
    # take the same branches as full width)
    llama, s3 = jcfg.spoken_lm.llama, jcfg.speech_decoder.llm
    steps, s3_steps = int(out_p["steps"]), int(syn_p["speech_token_lengths"].max())
    if layout == "float":
        assert not calls
    elif layout == "int8":
        assert calls.get("gated_mlp_int8_plain", 0) >= llama.num_hidden_layers * 2
        assert calls.get("ffn_int8_plain", 0) >= s3.num_blocks * 2
        assert calls.get("matmul_int4_plain", 0) == steps
    else:
        fused = layout == "int4_fused"
        mlp = (calls.get("gated_mlp_int4_plain", 0),
               calls.get("ffn_int4_plain", 0))
        assert mlp >= (llama.num_hidden_layers * 2, s3.num_blocks * 2) \
            if fused else mlp == (0, 0)
        assert not calls.get("gated_mlp_int8_plain") \
            and not calls.get("ffn_int8_plain")
        # qkv, o (+ gateup, down) per Llama layer and step, the tied head,
        # qkv, out (+ w_1, w_2) per S3 layer and step, the S3 head
        per_layer = 2 if fused else 4
        assert calls.get("matmul_int4_plain", 0) >= (
            per_layer * llama.num_hidden_layers * steps + steps
            + per_layer * s3.num_blocks * s3_steps + s3_steps)


# ---------------------------------------------------------------------------
# the slice's modules
# ---------------------------------------------------------------------------


def _lm_tree():
    return tiny_pair()[0], _float_variables()["params"]["spoken_lm"][
        "language_model"]


def _assert_same_state(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.dtype == r.dtype and g.shape == r.shape, k
        np.testing.assert_array_equal(g, r, err_msg=k)


@pytest.mark.parametrize("mode,fuse_qkv,fused_mlp,head", [
    ("int8", True, True, "int4"), ("int8", True, False, "int8"),
    ("int8", False, False, "int4"), ("int4", True, True, "int4"),
    ("int4", True, False, "int8"), ("int4", False, True, "int4"),
    ("int4", False, False, "int4")])
def test_quantizer_is_byte_identical_to_jax(mode, fuse_qkv, fused_mlp, head):
    from taste_spokenlm_tpu.utils import quant as jq
    jcfg, tree = _lm_tree()
    lora = jcfg.spoken_lm.lora
    merged_j = jax.tree.map(np.asarray, jq.merge_lora_params(tree, lora.alpha,
                                                             lora.r))
    merged_p = quant.merge_lora_params(
        convert.to_torch(convert.llama_state(tree, "")), lora.alpha, lora.r)
    ref = convert.llama_state(merged_j, "")
    assert sorted(merged_p) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(merged_p[k].numpy(), ref[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    # from the same float weights, the same bytes and scales
    q_j = jq.quantize_llama_params(merged_j, include_embed=True, mode=mode,
                                   embed_head_mode=head, fuse_qkv=fuse_qkv,
                                   fused_mlp=fused_mlp)
    q_p = quant.quantize_llama_params(
        convert.to_torch(ref), include_embed=True, mode=mode,
        embed_head_mode="int4head" if head == "int4" else head,
        fuse_qkv=fuse_qkv, fused_mlp=fused_mlp)
    _assert_same_state({k: v.numpy() for k, v in q_p.items()},
                       convert.llama_state(jax.tree.map(np.asarray, q_j), ""))

    llm = _float_variables()["params"]["speech_decoder"]["llm"]
    enc_j = jq.quantize_encoder_params(llm, mode=mode, fuse_qkv=fuse_qkv,
                                       fused_mlp=fused_mlp)
    enc_p = quant.quantize_encoder_params(
        convert.to_torch(convert.conformer_state(llm, "")), mode=mode,
        fuse_qkv=fuse_qkv, fused_mlp=fused_mlp)
    _assert_same_state({k: v.numpy() for k, v in enc_p.items()},
                       convert.conformer_state(jax.tree.map(np.asarray, enc_j),
                                               ""))


def _llama_pair(layout: str):
    """(jax LlamaModel, its params, the port's LlamaModel) in a layout."""
    from taste_spokenlm_tpu.models.llama import LlamaModel as JaxLlama
    from taste_spokenlm_tpu.utils import quant as jq
    jcfg, tree = _lm_tree()
    lcfg, lora = jcfg.spoken_lm.llama, jcfg.spoken_lm.lora
    pcfg = TasteConfig.tiny().spoken_lm.llama
    if layout == "merged":                # LoRA merged, float weights
        tree, lora = jq.merge_lora_params(tree, lora.alpha, lora.r), None
    elif layout != "float":
        # int8: unfused, int8 head; int4: fused qkv and gateup_proj;
        # *-fused: fused qkv and fused MLPs; both int4 layouts the int4 head
        tree = jq.merge_lora_params(tree, lora.alpha, lora.r)
        mode, fused = layout[:4], layout.endswith("-fused")
        qkv, head4 = fused or mode == "int4", fused or mode == "int4"
        flags = dict(quantized_serving=mode, fused_qkv_serving=qkv,
                     fused_mlp_serving=fused,
                     quantized_embed_serving="int4head" if head4 else True)
        tree = jq.quantize_llama_params(tree, include_embed=True, mode=mode,
                                        embed_head_mode="int4" if head4 else "int8",
                                        fuse_qkv=qkv, fused_mlp=fused)
        lcfg, pcfg, lora = lcfg.replace(**flags), pcfg.replace(**flags), None
    tree = jax.tree.map(np.asarray, tree)
    port = LlamaModel(pcfg, None if lora is None else
                      TasteConfig.tiny().spoken_lm.lora)
    port.load_state_dict(convert.to_torch(convert.llama_state(tree, "")),
                         strict=True)
    return JaxLlama(lcfg, lora), jax.tree.map(jnp.asarray, tree), port.eval()


@pytest.mark.parametrize("layout", ["float", "merged", "int8", "int8-fused",
                                    "int4", "int4-fused"])
def test_llama_prefill_and_cached_decode_match_jax(monkeypatch, layout):
    """Full-sequence forward with ragged lengths, then a cache prefill and
    two single-token steps at per-row rope offsets, and the tied head."""
    jlm, params, port = _llama_pair(layout)
    calls = _spy(monkeypatch)
    r = np.random.RandomState(20)
    ids = r.randint(0, 512, (2, 6)).astype(np.int32)
    lens = np.array([6, 4], np.int32)
    nxt = r.randint(0, 512, (2, 2)).astype(np.int32)

    def run_jax(m, ids, lens, nxt):
        full = m(input_ids=ids, attention_lengths=lens)["last_hidden"]
        caches = m.init_cache(2, 9)
        kv = jnp.arange(9)[None, :] < lens[:, None]
        out = m(input_ids=ids, caches=caches, cache_index=jnp.int32(0),
                key_valid=kv)
        steps = [out["last_hidden"]]
        for s in range(2):
            kv = kv | (jnp.arange(9) == 6 + s)[None, :]
            out = m(input_ids=nxt[:, s:s + 1], caches=out["caches"],
                    cache_index=jnp.int32(6 + s), position_offset=lens + s,
                    key_valid=kv)
            steps.append(out["last_hidden"])
        return full, steps, m.logits(steps[-1])
    full_j, steps_j, logits_j = jax.jit(lambda p, *a: jlm.apply(
        {"params": p}, *a, method=run_jax))(params, ids, lens, nxt)

    with torch.no_grad():
        full_p = port(input_ids=t(ids).long(),
                      attention_lengths=t(lens).long())["last_hidden"]
        caches = port.init_cache(2, 9)
        kv = torch.arange(9)[None, :] < t(lens)[:, None]
        out = port(input_ids=t(ids).long(), caches=caches, cache_index=0,
                   key_valid=kv)
        steps_p = [out["last_hidden"]]
        for s in range(2):
            kv = kv | (torch.arange(9) == 6 + s)[None, :]
            out = port(input_ids=t(nxt[:, s:s + 1]).long(), caches=out["caches"],
                       cache_index=6 + s, position_offset=t(lens).long() + s,
                       key_valid=kv)
            steps_p.append(out["last_hidden"])
        logits_p = port.logits(steps_p[-1])
    # past a kernel's bf16 cast of x: 1e-3
    tol = 1e-4 if layout in ("float", "merged", "int8") else 1e-3
    for row, n in enumerate(lens):      # padded query rows are junk
        assert rel_err(full_p[row, :n].numpy(), full_j[row, :n]) <= tol
        assert rel_err(steps_p[0][row, :n].numpy(), steps_j[0][row, :n]) <= tol
    for got, ref in zip(steps_p[1:], steps_j[1:]):
        assert rel_err(got.numpy(), ref) <= tol
    assert rel_err(logits_p.numpy(), logits_j) <= tol
    # 4 passes over 2 layers; the int4 layouts' qkv, o (+ gateup, down)
    # per layer and pass, and the int4 head once
    if layout == "int8-fused":
        assert calls["gated_mlp_int8_plain"] == 4 * 2
        assert calls["matmul_int4_plain"] == 1
    elif layout == "int4-fused":
        assert calls["gated_mlp_int4_plain"] == 4 * 2
        assert calls["matmul_int4_plain"] == 2 * 4 * 2 + 1
    elif layout == "int4":
        assert calls["matmul_int4_plain"] == 4 * 4 * 2 + 1
        assert "gated_mlp_int4_plain" not in calls


@pytest.mark.parametrize("layout", ["int4", "int4-fused"])
def test_llama_int4_prefill_over_256_rows_matches_jax(monkeypatch, layout):
    """A 2 x 130-row prefill takes the dequantizing branches (no kernel), the
    next cached step the kernels, on both sides."""
    jlm, params, port = _llama_pair(layout)
    calls = _spy(monkeypatch)
    r = np.random.RandomState(23)
    ids = r.randint(0, 512, (2, 130)).astype(np.int32)
    nxt = r.randint(0, 512, (2, 1)).astype(np.int32)

    def run_jax(m, ids, nxt):
        out = m(input_ids=ids, caches=m.init_cache(2, 131),
                cache_index=jnp.int32(0))
        step = m(input_ids=nxt, caches=out["caches"],
                 cache_index=jnp.int32(130), position_offset=130)
        return out["last_hidden"], step["last_hidden"]
    pre_j, step_j = jax.jit(lambda p, *a: jlm.apply(
        {"params": p}, *a, method=run_jax))(params, ids, nxt)
    with torch.no_grad():
        out = port(input_ids=t(ids).long(), caches=port.init_cache(2, 131),
                   cache_index=0)
        pre_p = out["last_hidden"]
        assert not calls                    # 260 rows: no kernel
        step_p = port(input_ids=t(nxt).long(), caches=out["caches"],
                      cache_index=130, position_offset=130)["last_hidden"]
    assert rel_err(pre_p.numpy(), pre_j) <= 1e-4
    assert rel_err(step_p.numpy(), step_j) <= 1e-3
    assert calls["matmul_int4_plain"] == (2 if layout == "int4-fused" else 4) * 2
    assert calls.get("gated_mlp_int4_plain", 0) == \
        (2 if layout == "int4-fused" else 0)


def test_bridges_match_jax():
    """The default pair on the tiny model's weights, and simple_sum /
    linear_last from their own init."""
    from taste_spokenlm_tpu.models import bridges as jb
    from taste_spokenlm_tpu.models.quantizer import Codebook as JaxCodebook
    from taste_spokenlm_tpu_torch.models import bridges as pb
    from taste_spokenlm_tpu_torch.models.quantizer import Codebook
    jcfg, port = _pair("float")[0], _pair("float")[3]
    slm = _float_variables()["params"]["spoken_lm"]
    r = np.random.RandomState(21)
    h, a = jcfg.spoken_lm.llama.hidden_size, jcfg.audio_tower.audio_embed_dim
    q = jcfg.audio_tower.quantizer
    text = r.randn(2, 3, h).astype(np.float32)
    audio = r.randn(2, 3, a).astype(np.float32)
    embed = r.randn(q.num_quantizers, q.codebook_size, q.codebook_dim
                    ).astype(np.float32)
    cb_j, cb_p = JaxCodebook(jnp.asarray(embed)), Codebook(t(embed))
    checks = [
        (jb.WeightedSumFusion(h), slm["fuse_for_bridge_in_llm"],
         port.spoken_lm.fuse_for_bridge_in_llm, (text, audio)),
        (jb.ContinueLatentLinearLastExtract(k=q.codebook_size, d=q.codebook_dim),
         slm["extract_for_bridge_out_llm"], port.spoken_lm.extract_for_bridge_out_llm,
         (text,)),
    ]
    for jmod, pmod in ((jb.SimpleSumFusion(h), pb.SimpleSumFusion(h, a)),
                       (jb.LinearLastExtract(k=q.codebook_size, l=q.num_quantizers),
                        pb.LinearLastExtract(h, q.codebook_size, q.num_quantizers))):
        args = (text, audio) if "Fusion" in type(jmod).__name__ else (text,)
        p = jmod.init(jax.random.PRNGKey(0), *map(jnp.asarray, args))["params"]
        if "alpha" in p:                  # away from relu's zero
            p = dict(p, alpha=jnp.float32(0.7))
        checks.append((jmod, p, pmod, args))
    for jmod, p, pmod, args in checks:
        p = jax.tree.map(np.asarray, p)
        state = convert.spoken_lm_state({"fuse_for_bridge_in_llm": p}, "")
        pmod.load_state_dict({k.split(".", 1)[1]: v for k, v in
                              convert.to_torch(state).items()}, strict=True)
        extract = len(args) == 1
        ref = jmod.apply({"params": p}, *map(jnp.asarray, args),
                         **({"cb": cb_j} if extract else {}))
        with torch.no_grad():
            got = pmod(*map(t, args), cb_p) if extract else pmod(*map(t, args))
        if extract:
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
            for k in ref[1]:
                assert rel_err(got[1][k].detach().numpy(), ref[1][k]) <= 1e-4
        else:
            assert rel_err(got.numpy(), ref) <= 1e-4


@pytest.mark.parametrize("layout,t_len", [("int8", 7), ("int8", 130),
                                          ("int4_fused", 7),
                                          ("int4_fused", 130), ("int4", 7),
                                          ("int4", 130)])
def test_quantized_conformer_matches_jax(monkeypatch, layout, t_len):
    """The quantized fused-qkv S3 llm stack, its FFN fused (int8,
    int4_fused) or not (int4): a full forward (14 rows take the fused FFN
    and the int4 kernel, 260 the unfused, dequantizing math on the same
    weights) and cached decode steps."""
    jcfg, model, variables, port = _pair(layout)
    calls = _spy(monkeypatch)
    sd = jcfg.speech_decoder
    r = np.random.RandomState(22)
    x = r.randn(2, t_len, sd.llm.input_size).astype(np.float32)
    lens = np.array([t_len, t_len - 2], np.int32)
    ref = jax.jit(lambda v, *a: model.apply(
        v, *a, method=lambda m, *b: m.speech_decoder.llm(*b)))(
            variables, jnp.asarray(x), jnp.asarray(lens))
    llm = port.speech_decoder.llm
    with torch.no_grad():
        got = llm(t(x), t(lens).long())
    assert rel_err(got.numpy(), ref) <= 1e-3
    small = 2 * t_len <= 256
    ffn = {"int8": "ffn_int8_plain", "int4_fused": "ffn_int4_plain"}
    assert calls.get(ffn.get(layout), 0) == (sd.llm.num_blocks if small
                                             and layout in ffn else 0)
    # the int4 projections: qkv, out, pos (+ w_1, w_2) per layer
    per_layer = {"int8": 0, "int4_fused": 3, "int4": 5}[layout]
    assert calls.get("matmul_int4_plain", 0) == (
        per_layer * sd.llm.num_blocks if small else 0)
    if t_len > 7:
        return

    def jax_decode(m, xs):
        llm = m.speech_decoder.llm
        caches = llm.init_cache(2, 9)
        pp = llm.precompute_pos_projs(9)
        h1, caches = llm.decode_step(xs[:, :5], caches, jnp.int32(0), pos_projs=pp)
        h2, _ = llm.decode_step(xs[:, 5:6], caches, jnp.int32(5), pos_projs=pp)
        return h1, h2
    refs = jax.jit(lambda v, a: model.apply(v, a, method=jax_decode))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        caches = llm.init_cache(2, 9)
        pp = llm.precompute_pos_projs(9)
        h1, caches = llm.decode_step(t(x[:, :5]), caches, 0, pos_projs=pp)
        h2, _ = llm.decode_step(t(x[:, 5:6]), caches, 5, pos_projs=pp)
    for g, rr in zip((h1, h2), refs):
        assert rel_err(g.numpy(), rr) <= 1e-3


def test_unported_layouts_name_their_roadmap_item():
    """Every bridge is ported now: the registries hold JAX's keys and the
    layouts that used to raise build."""
    from taste_spokenlm_tpu.models import bridges as jb
    from taste_spokenlm_tpu_torch.models import bridges
    assert set(bridges.BRIDGE_FUSION_CLASSES) == set(jb.BRIDGE_FUSION_CLASSES)
    assert set(bridges.BRIDGE_EXTRACT_CLASSES) == set(jb.BRIDGE_EXTRACT_CLASSES)
    assert isinstance(bridges.make_extract("multi_linear_last", 8, 4, 4, 2),
                      bridges.MultiLinearLastExtract)
    assert isinstance(bridges.make_fusion("reference_mix", 8, 4),
                      bridges.ReferenceMixFusion)


@pytest.mark.parametrize("layout", ["int4_fused", "int4"])
def test_jax_int4_tree_loads_and_keeps_its_types(layout):
    """The JAX-quantized int4 tree loaded through convert.py (strict=True):
    packed uint8 weights and 2-D float32 group scales, both kept through
    a cast of the model to bfloat16."""
    port = copy.deepcopy(_pair(layout)[3]).to(torch.bfloat16)
    sd = port.state_dict()
    fused = layout == "int4_fused"
    pre = "spoken_lm.language_model.layers.0."
    down = sd[pre + "mlp.down_proj.base_q4"]
    llama = TasteConfig.tiny().spoken_lm.llama
    assert down.dtype == torch.uint8
    assert down.shape == (llama.intermediate_size // 2, llama.hidden_size)
    assert (pre + "mlp.gateup_proj.base_q4" in sd) != fused
    packed = [k for k in sd if k.endswith(("base_q4", "kernel_q4"))]
    assert packed and all(sd[k].dtype == torch.uint8 for k in packed)
    for k in packed:
        scale = sd[k.rsplit(".", 1)[0] + (".scale" if k.endswith("kernel_q4")
                                          else ".base_scale")]
        assert scale.dtype == torch.float32 and scale.dim() == 2
        assert scale.shape[1] == sd[k].shape[1]
    head = sd["speech_decoder.llm_decoder.kernel_q4"]
    assert head.shape[1] == TasteConfig.tiny().speech_decoder.speech_token_size + 1


@pytest.mark.parametrize("delay,level", [(1, "word"), (2, "token"), (0, "word")])
def test_prepare_conditional_embeds_matches_jax(delay, level):
    """The conditional prefix for each delay: inputs, lengths, taste labels
    and the delayed audio stream."""
    jcfg, _, _, _ = tiny_pair()
    jcfg = jcfg.replace(spoken_lm=jcfg.spoken_lm.replace(delay=delay,
                                                         delay_level=level))
    pcfg = TasteConfig.tiny()
    pcfg = pcfg.replace(spoken_lm=pcfg.spoken_lm.replace(delay=delay,
                                                         delay_level=level))
    variables = _float_variables()
    if delay == 0:                       # no pad-text embed without a delay
        slm = dict(variables["params"]["spoken_lm"])
        slm.pop("pad_text_unit_embed")
        variables = dict(variables, params=dict(variables["params"],
                                                spoken_lm=slm))
    port = port_model(pcfg, variables)
    model = JaxTaste(jcfg)
    lm = lm_inputs(jcfg)
    keys = ("llm_indices", "llm_token_ids", "llm_token_lengths", "llm_word_ids")
    ref = jax.jit(lambda v, *a: model.apply(
        v, *a, method=lambda m, *b: m.spoken_lm.prepare_conditional_embeds(
            m._cb(), *b)))(jax.tree.map(jnp.asarray, variables),
                           *(jnp.asarray(lm[k]) for k in keys))
    with torch.no_grad():
        got = port.spoken_lm.prepare_conditional_embeds(
            port._cb(), *(t(lm[k]).long() for k in keys))
    for g, r in zip(got, ref):
        if np.issubdtype(np.asarray(r).dtype, np.integer):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        else:
            assert rel_err(g.numpy(), r) <= 1e-4


@pytest.mark.parametrize("mode", ["text", "zero", "instruct"])
def test_generate_modes_match_jax(mode):
    """The joint decode's other conditioning modes, greedy, float layout."""
    jcfg, model, variables, port = tiny_pair()
    tables_np = build_sampler_tables(VocabScan(), jcfg.spoken_lm.llama.vocab_size)
    lm = lm_inputs(jcfg)
    keys = ("llm_indices", "llm_token_ids", "llm_token_lengths", "llm_word_ids")
    pre, suf = np.array([5, 6, 7], np.int32), np.array([8, 9], np.int32)
    extra = (pre, suf) if mode == "instruct" else (None, None)
    ref = jax.jit(lambda v, *a: model.apply(
        v, jax.random.PRNGKey(0), JaxSamplerConfig(**SAMPLER),
        {k: jnp.asarray(x) for k, x in tables_np.items()}, *a[:4], mode,
        MAX_STEPS, *a[4:], method=JaxTaste.generate_completion))(
            variables, *(jnp.asarray(lm[k]) for k in keys),
            *(None if e is None else jnp.asarray(e) for e in extra))
    got = port.generate_completion(
        SamplerConfig(**SAMPLER), {k: torch.from_numpy(x)
                                   for k, x in tables_np.items()},
        *(t(lm[k]).long() for k in keys), mode, MAX_STEPS,
        *(None if e is None else t(e).long() for e in extra))
    for key in ("llm_token_ids", "llm_word_ids", "taste_indices",
                "num_tokens", "num_taste_words"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    assert (got["num_tokens"].numpy() >= 2).all()
