"""The bridges and the spoken LM's variants of the PyTorch port against
the JAX package, on the CPU: every entry of the two bridge registries on
its own, and TasteSpokenLM under each audio-embed mode and with the
weighted-layer, all-concat, continue and multi-head out-bridges and the
reference-mix in-bridge (the teacher-forced forward and its losses; the
greedy KV-cached joint decode for three of them, one reading every hidden
state each step).  Weights cross through taste_spokenlm_tpu_torch.convert,
strict.

Tolerances: f32 floats 1e-4 relative to the reference's max |value|;
one-hot logits, ids and trajectories exact.  Wall: about 45 s on one
worker (python -m pytest tests/test_torch_spoken_variants.py -q).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taste_spokenlm_tpu_torch import convert
from torch_parity_common import (VocabScan, _fill_spoken_lm, fill_params,
                                 lm_inputs, rel_err, t)

torch.set_num_threads(2)
TOL = 1e-4


# ---------------------------------------------------------------------------
# bridges
# ---------------------------------------------------------------------------

H, A, K, D, L, NL = 16, 12, 16, 8, 3, 4


def _jax_bridge(kind, name):
    from taste_spokenlm_tpu.models import bridges as jb
    if kind == "fusion":
        return jb.BRIDGE_FUSION_CLASSES[name](llm_dim=H)
    cls = jb.BRIDGE_EXTRACT_CLASSES[name]
    if name == "reference_mix":
        return cls(audio_dim=A)
    if name in ("linear_last", "linear_all_concat", "multi_linear_last"):
        return cls(k=K, l=L, **({"d": D} if name.startswith("multi") else {}))
    if name == "weighted_layer":
        return cls(k=K, l=L, num_layers=NL)
    if name == "continue_latent_linear_last":
        return cls(k=K, d=D)
    return cls(k=K, d=D, num_layers=NL)


BRIDGES = ([("fusion", n) for n in ("weighted_sum", "reference_mix",
                                    "simple_sum")]
           + [("extract", n) for n in (
               "linear_last", "linear_all_concat", "reference_mix",
               "weighted_layer", "continue_weighted_layer",
               "continue_latent_linear_last",
               "continue_latent_weighted_layer", "multi_linear_last")])


@pytest.mark.parametrize("kind,name", BRIDGES)
def test_bridge_matches_jax(kind, name):
    """Each registry entry on random weights: logits (one-hots exact),
    embeddings and the info dict (latents, soft codes) at 1e-4."""
    from taste_spokenlm_tpu.models.quantizer import Codebook as JCb
    from taste_spokenlm_tpu_torch.models import bridges as pb
    from taste_spokenlm_tpu_torch.models.quantizer import Codebook
    r = np.random.RandomState(6)
    text = r.randn(2, 3, H).astype(np.float32)
    audio = r.randn(2, 3, A).astype(np.float32)
    hs = tuple(r.randn(2, 3, H).astype(np.float32) for _ in range(NL))
    embed = r.randn(L, K, D).astype(np.float32)
    jmod = _jax_bridge(kind, name)
    if kind == "fusion":
        jargs, jkw = (jnp.asarray(text), jnp.asarray(audio)), {}
    else:
        jargs = (jnp.asarray(text), tuple(map(jnp.asarray, hs)),
                 JCb(jnp.asarray(embed)))
        jkw = {"audio_embeds": jnp.asarray(audio)} if name == "reference_mix" \
            else {}
    shapes = jax.eval_shape(functools.partial(jmod.init, **jkw),
                            jax.random.PRNGKey(0), *jargs)
    params = fill_params(shapes["params"], 7)
    ref = jmod.apply({"params": params}, *jargs, **jkw)
    pmod = (pb.make_fusion(name, H, A) if kind == "fusion"
            else pb.make_extract(name, H, K, D, L, NL))
    if name == "reference_mix" and kind == "extract":
        pmod = pb.ReferenceMixExtract(H, A)
    pmod.load_state_dict(convert.to_torch(convert.bridge_state(params, "")),
                         strict=True)
    with torch.no_grad():
        if kind == "fusion":
            assert rel_err(pmod(t(text), t(audio)).numpy(), ref) <= TOL
            return
        got = pmod(t(text), Codebook(t(embed)),
                   hidden_states=tuple(map(t, hs)),
                   **({"audio_embeds": t(audio)} if name == "reference_mix"
                      else {}))
    if "continue" in name:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    else:
        assert rel_err(got[0].numpy(), ref[0]) <= TOL
    assert set(got[1]) == set(ref[1])
    for k2 in ref[1]:
        assert rel_err(got[1][k2].detach().numpy(), ref[1][k2]) <= TOL, k2


# ---------------------------------------------------------------------------
# the spoken LM
# ---------------------------------------------------------------------------

SPOKEN = [("pad", None, None), ("embed_a0_only", None, None),
          ("get_codes_from_indices", None, None),
          (None, "linear_all_concat", None), (None, "weighted_layer", None),
          (None, "continue_weighted_layer", None),
          (None, "continue_latent_weighted_layer", None),
          (None, "multi_linear_last", None), (None, None, "reference_mix")]
DECODED = ("get_codes_from_indices", "continue_latent_weighted_layer",
           "reference_mix")
SAMPLER = dict(delay=1, delay_level="word", text_top_p=0.0, taste_top_p=0.0,
               extra_words=4, has_prefix=True)


@pytest.mark.parametrize("mode,out,inm", SPOKEN)
def test_spoken_lm_variant_matches_jax(mode, out, inm):
    """The forward's losses and logits (taste one-hots exact), and for
    three variants the greedy joint decode token for token."""
    from taste_spokenlm_tpu.config import TasteConfig as JTaste
    from taste_spokenlm_tpu.models.quantizer import Codebook as JCb
    from taste_spokenlm_tpu.models.sampler import SamplerConfig as JSamp
    from taste_spokenlm_tpu.models.sampler import build_sampler_tables
    from taste_spokenlm_tpu.models.spoken_lm import TasteSpokenLM as JLM
    from taste_spokenlm_tpu_torch.config import TasteConfig
    from taste_spokenlm_tpu_torch.models.quantizer import Codebook
    from taste_spokenlm_tpu_torch.models.sampler import SamplerConfig
    from taste_spokenlm_tpu_torch.models.spoken_lm import TasteSpokenLM
    kw = {}
    if mode:
        kw["audio_embed_conv_mode"] = mode
    if out:
        kw["out_llm_module"] = out
    if inm:
        kw["in_llm_module"] = inm
    jcfg = JTaste.tiny()
    q = jcfg.audio_tower.quantizer
    dims = dict(audio_dim=q.dim, taste_k=q.codebook_size,
                taste_d=q.codebook_dim, taste_l=q.num_quantizers)
    r = np.random.RandomState(20)
    embed = r.randn(q.num_quantizers, q.codebook_size, q.codebook_dim
                    ).astype(np.float32)
    proj = (r.randn(q.codebook_dim, q.dim) / 4).astype(np.float32)
    bias = (0.1 * r.randn(q.dim)).astype(np.float32)
    cb_j = JCb(jnp.asarray(embed), jnp.asarray(proj), jnp.asarray(bias))
    cb_p = Codebook(t(embed), t(proj.T.copy()), t(bias))
    lm = lm_inputs(jcfg, 8)
    names = ("llm_indices", "llm_token_ids", "llm_token_lengths",
             "llm_word_ids")
    jargs = tuple(jnp.asarray(lm[k]) for k in names)
    pargs = tuple(t(lm[k]).long() for k in names)
    jmod = JLM(jcfg.spoken_lm.replace(**kw), **dims)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), cb_j, *jargs)
    rs = np.random.RandomState(21)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: _fill_spoken_lm(p, x, rs), shapes["params"])
    port = TasteSpokenLM(TasteConfig.tiny().spoken_lm.replace(**kw), **dims)
    port.load_state_dict(convert.to_torch(convert.spoken_lm_state(
        params, "")), strict=True)
    port.eval()
    ref = jax.jit(lambda v, c, *a: jmod.apply(v, c, *a))(
        {"params": params}, cb_j, *jargs)
    with torch.no_grad():
        got = port(cb_p, *pargs)
    for k2 in ("loss", "text_loss", "taste_loss"):
        assert abs(float(got[k2]) - float(ref[k2])) <= TOL * max(
            1.0, abs(float(ref[k2]))), k2
    if "continue" in jmod.config.out_llm_module:
        np.testing.assert_array_equal(got["taste_logits"].numpy(),
                                      np.asarray(ref["taste_logits"]))
    else:
        assert rel_err(got["taste_logits"].numpy(), ref["taste_logits"]) <= TOL
    assert rel_err(got["text_logits"].numpy(), ref["text_logits"]) <= TOL
    if (mode or out or inm) not in DECODED:
        return
    v = jcfg.spoken_lm.llama.vocab_size
    tables = build_sampler_tables(VocabScan(), v)
    gen = jax.jit(lambda var, c, *a: jmod.apply(
        var, jax.random.PRNGKey(0), c, JSamp(**SAMPLER),
        {k: jnp.asarray(x) for k, x in tables.items()}, *a, "audio", 12,
        method=JLM.generate))({"params": params}, cb_j, *jargs)
    got = port.generate(cb_p, SamplerConfig(**SAMPLER),
                        {k: torch.from_numpy(x) for k, x in tables.items()},
                        *pargs, max_steps=12)
    for k2 in ("llm_token_ids", "llm_word_ids", "taste_indices",
               "num_tokens", "num_taste_words"):
        np.testing.assert_array_equal(got[k2].numpy(), np.asarray(gen[k2]),
                                      err_msg=k2)
    assert got["num_taste_words"].sum() >= 1   # the decode sampled taste
