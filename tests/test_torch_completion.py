"""The port's completion slice (joint text + taste decode -> S3 -> mel ->
wav) against the same composition in JAX at TasteConfig.tiny(), float32 on
the CPU, in the float layout (LoRA adapters) and in the int8 fused serving
layout (merged LoRA, int8 Llama with the int4 tied head, fused qkv and
fused MLPs, int8 S3 llm stack), both from the JAX package's weights through
taste_spokenlm_tpu_torch.convert (strict=True).

generate_completion runs greedy (text_top_p 0, taste_top_p 0), the S3
decode greedy (sampling_k 1), and the voice generator takes the JAX split
chain's noise.  The text, word, taste and S3 trajectories must be equal
exactly, the waveform within 1e-3 absolute (the sine source's f32 phase
cumsum runs in another summation order).  In the int8 layout the JAX side
runs its Pallas kernels in interpret mode, and a spy on the port's plain
kernel versions shows that the fused-MLP and int4-head branches ran.
"""

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


@functools.lru_cache(maxsize=None)
def _pair(layout: str):
    if layout == "float":
        return tiny_pair()
    jcfg = serving_config(tiny_pair()[0])
    variables = quantize_variables_jax(jcfg, _float_variables())
    return jcfg, JaxTaste(jcfg), jax.tree.map(jnp.asarray, variables), \
        port_model(serving_config(TasteConfig.tiny()), variables)


def _spy(monkeypatch):
    """Counts of the port's plain kernel versions (what its wrappers run on
    the CPU)."""
    calls = {}
    for mod, name in ((fused_mlp, "gated_mlp_int8_plain"),
                      (fused_mlp, "ffn_int8_plain"),
                      (int4_matmul, "matmul_int4_plain")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("layout", ["float", "int8"])
def test_completion_and_synthesis_match_jax(monkeypatch, layout):
    jcfg, model, variables, port = _pair(layout)
    calls = _spy(monkeypatch)
    v = jcfg.spoken_lm.llama.vocab_size
    tables_np = build_sampler_tables(VocabScan(), v)
    lm = lm_inputs(jcfg)

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
    # stopped early: the sampler's countdown ended the decode
    assert int(out_p["steps"]) < MAX_STEPS

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

    if layout == "int8":
        # the fused MLPs and the int4 head ran (no width gate: tiny sizes
        # take the same branches as full width)
        llama, s3 = jcfg.spoken_lm.llama, jcfg.speech_decoder.llm
        assert calls.get("gated_mlp_int8_plain", 0) >= llama.num_hidden_layers * 2
        assert calls.get("ffn_int8_plain", 0) >= s3.num_blocks * 2
        assert calls.get("matmul_int4_plain", 0) == int(out_p["steps"])
    else:
        assert not calls


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


@pytest.mark.parametrize("fuse_qkv,fused_mlp,head", [(True, True, "int4"),
                                                     (True, False, "int8"),
                                                     (False, False, "int4")])
def test_quantizer_is_byte_identical_to_jax(fuse_qkv, fused_mlp, head):
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
    q_j = jq.quantize_llama_params(merged_j, include_embed=True,
                                   embed_head_mode=head, fuse_qkv=fuse_qkv,
                                   fused_mlp=fused_mlp)
    q_p = quant.quantize_llama_params(
        convert.to_torch(ref), include_embed=True,
        embed_head_mode="int4head" if head == "int4" else head,
        fuse_qkv=fuse_qkv, fused_mlp=fused_mlp)
    _assert_same_state({k: v.numpy() for k, v in q_p.items()},
                       convert.llama_state(jax.tree.map(np.asarray, q_j), ""))

    llm = _float_variables()["params"]["speech_decoder"]["llm"]
    enc_j = jq.quantize_encoder_params(llm, fuse_qkv=fuse_qkv,
                                       fused_mlp=fused_mlp)
    enc_p = quant.quantize_encoder_params(
        convert.to_torch(convert.conformer_state(llm, "")), fuse_qkv=fuse_qkv,
        fused_mlp=fused_mlp)
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
        tree = jq.merge_lora_params(tree, lora.alpha, lora.r)
        fused = layout == "int8-fused"
        flags = dict(quantized_serving="int8", fused_qkv_serving=fused,
                     fused_mlp_serving=fused,
                     quantized_embed_serving="int4head" if fused else True)
        tree = jq.quantize_llama_params(tree, include_embed=True,
                                        embed_head_mode="int4" if fused else "int8",
                                        fuse_qkv=fused, fused_mlp=fused)
        lcfg, pcfg, lora = lcfg.replace(**flags), pcfg.replace(**flags), None
    tree = jax.tree.map(np.asarray, tree)
    port = LlamaModel(pcfg, None if lora is None else
                      TasteConfig.tiny().spoken_lm.lora)
    port.load_state_dict(convert.to_torch(convert.llama_state(tree, "")),
                         strict=True)
    return JaxLlama(lcfg, lora), jax.tree.map(jnp.asarray, tree), port.eval()


@pytest.mark.parametrize("layout", ["float", "merged", "int8", "int8-fused"])
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
    tol = 1e-4 if layout != "int8-fused" else 1e-3
    for row, n in enumerate(lens):      # padded query rows are junk
        assert rel_err(full_p[row, :n].numpy(), full_j[row, :n]) <= tol
        assert rel_err(steps_p[0][row, :n].numpy(), steps_j[0][row, :n]) <= tol
    for got, ref in zip(steps_p[1:], steps_j[1:]):
        assert rel_err(got.numpy(), ref) <= tol
    assert rel_err(logits_p.numpy(), logits_j) <= tol
    if layout == "int8-fused":
        assert calls["gated_mlp_int8_plain"] == 4 * 2
        assert calls["matmul_int4_plain"] == 1


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


@pytest.mark.parametrize("t_len", [7, 130])
def test_quantized_conformer_matches_jax(monkeypatch, t_len):
    """The int8 fused-qkv / fused-FFN S3 llm stack: a full forward (14 rows
    take the fused FFN, 260 the unfused math on the same weights) and
    cached decode steps."""
    jcfg, model, variables, port = _pair("int8")
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
    assert calls.get("ffn_int8_plain", 0) == (sd.llm.num_blocks
                                              if 2 * t_len <= 256 else 0)
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
    from taste_spokenlm_tpu_torch.models import bridges
    llama = TasteConfig.tiny().spoken_lm.llama
    with pytest.raises(NotImplementedError, match="queue B"):
        LlamaModel(llama.replace(quantized_serving="int4"))
    with pytest.raises(NotImplementedError, match="queue B"):
        quant.quantize_kernel(torch.zeros(4, 4), "int4")
    with pytest.raises(NotImplementedError, match="queue B"):
        convert.llama_state({"layers_0": {"mlp": {"up_proj": {
            "base_q4": np.zeros((2, 4), np.uint8)}}}}, "")
    with pytest.raises(NotImplementedError, match="queue A item 8"):
        bridges.make_extract("multi_linear_last", 8, 4, 4, 2)
    with pytest.raises(NotImplementedError, match="queue A item 8"):
        bridges.make_fusion("reference_mix", 8, 4)


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
