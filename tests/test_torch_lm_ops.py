"""The completion slice's tensor ops against the JAX package's on the CPU:
nucleus masks and the repetition penalty (the same masks exactly, ties
included), the branchless joint sampler step by step (greedy, and sampled
with JAX's own Gumbel noise on its split keys handed to the port), and the
spoken LM's index helpers (fill-forward, word starts, row compaction, the
nearest-codebook search).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taste_spokenlm_tpu.models import quantizer as jax_quantizer
from taste_spokenlm_tpu.models import sampler as jax_sampler
from taste_spokenlm_tpu.models import spoken_lm as jax_spoken_lm
from taste_spokenlm_tpu.ops import sampling as jax_sampling
from taste_spokenlm_tpu.ops import segment as jax_segment
from taste_spokenlm_tpu_torch.models import quantizer, sampler, spoken_lm
from taste_spokenlm_tpu_torch.ops import sampling, segment

from torch_parity_common import VocabScan, t

torch.set_num_threads(2)
NEG = float(jax_sampling.NEG_INF)


def _logits_with_ties(r, shape):
    x = (r.randn(*shape) * 2).astype(np.float32)
    x[..., 1::7] = x[..., 0:1]              # a tied group at the top value
    x[..., 5::11] = x[..., 3:4]
    return x


@pytest.mark.parametrize("p", [0.3, 0.75, 0.95])
def test_mask_top_p_keeps_the_same_set_as_jax(p):
    r = np.random.RandomState(30)
    x = _logits_with_ties(r, (6, 1000))
    x[:2, 10:200] = NEG                     # banned entries already masked
    ref = np.asarray(jax.jit(jax_sampling.mask_top_p, static_argnums=1)(
        jnp.asarray(x), p))
    got = sampling.mask_top_p(t(x), p).numpy()
    np.testing.assert_array_equal(got == NEG, ref == NEG)
    np.testing.assert_array_equal(got, ref)
    assert ((got != NEG).sum(-1) >= 1).all()


def test_repetition_penalty_and_temperature_match_jax():
    r = np.random.RandomState(31)
    x = _logits_with_ties(r, (3, 300))
    counts = r.randint(0, 3, (3, 300)).astype(np.int32)
    ref = jax_sampling.temperature_scale(jax_sampling.apply_repetition_penalty(
        jnp.asarray(x), jnp.asarray(counts), 1.1), 0.5)
    got = sampling.temperature_scale(sampling.apply_repetition_penalty(
        t(x), t(counts), 1.1), 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("sampled,delay_level", [(False, "word"), (True, "word"),
                                                 (True, "token")])
def test_sampler_step_reproduces_jax_step_by_step(sampled, delay_level):
    v, l, k = 330, 4, 16
    tables_np = jax_sampler.build_sampler_tables(VocabScan(), v)
    np.testing.assert_array_equal(
        sampler.build_sampler_tables(VocabScan(), v)["banned"], tables_np["banned"])
    cfg = dict(delay=1, delay_level=delay_level, extra_words=3,
               text_top_p=0.6 if sampled else 0.0,
               taste_top_p=0.5 if sampled else 0.0, text_temperature=0.5,
               repetition_penalty=1.1, stop_id=7 if sampled else -1)
    jcfg, pcfg = jax_sampler.SamplerConfig(**cfg), sampler.SamplerConfig(**cfg)
    tables_j = {n: jnp.asarray(a) for n, a in tables_np.items()}
    tables_p = {n: torch.from_numpy(a) for n, a in tables_np.items()}
    step_j = jax.jit(functools.partial(jax_sampler.sampler_step, cfg=jcfg,
                                       tables=tables_j))
    st_j = jax_sampler.init_state(v, 1)
    st_p = sampler.init_state(1, v, 1)
    r = np.random.RandomState(32)
    for i in range(14):
        text = (r.randn(v) * 3).astype(np.float32)
        taste = r.randn(l, k).astype(np.float32)
        key = jax.random.PRNGKey(100 + i)
        st_j, out_j = step_j(key, st_j, jnp.asarray(text), jnp.asarray(taste))
        k_text, k_taste = jax.random.split(key)
        noise = ((t(jax.random.gumbel(k_text, (v,)))[None],
                  t(jax.random.gumbel(k_taste, (l, k)))[None])
                 if sampled else (None, None))
        st_p, out_p = sampler.sampler_step(st_p, t(text)[None], t(taste)[None],
                                           pcfg, tables_p, *noise)
        for name in out_j._fields:
            np.testing.assert_array_equal(getattr(out_p, name).numpy()[0],
                                          np.asarray(getattr(out_j, name)),
                                          err_msg=f"step {i}: {name}")
        for name in st_j._fields:
            np.testing.assert_array_equal(getattr(st_p, name).numpy()[0],
                                          np.asarray(getattr(st_j, name)),
                                          err_msg=f"step {i}: state {name}")


def test_spoken_lm_index_helpers_match_jax():
    r = np.random.RandomState(33)
    idx = r.randint(0, 50, (2, 7, 3)).astype(np.int32)
    idx[0, [0, 2, 3, 6]] = -1
    idx[1, [4, 5]] = -1
    np.testing.assert_array_equal(
        spoken_lm.fill_forward_indices(t(idx).long()).numpy(),
        np.asarray(jax_spoken_lm.fill_forward_indices(jnp.asarray(idx))))
    wid = np.array([[0, 0, 1, 2, 2, 3, 3], [0, 1, 1, 1, 2, 0, 0]], np.int32)
    lens = np.array([7, 5], np.int32)
    for got, ref in zip(
            spoken_lm.word_start_positions(t(wid).long(), t(lens).long()),
            jax_spoken_lm.word_start_positions(jnp.asarray(wid),
                                               jnp.asarray(lens))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        segment.word_count(t(wid).long(), t(lens).long()).numpy(),
        np.asarray(jax_segment.word_count(jnp.asarray(wid), jnp.asarray(lens))))
    valid = np.array([[1, 0, 1, 1, 0, 1, 0], [0, 0, 1, 0, 1, 1, 1]], bool)
    for out_len in (3, 5):
        np.testing.assert_array_equal(
            segment.compact_valid_rows(t(idx).long(), t(valid), out_len,
                                       pad_value=9).numpy(),
            np.asarray(jax_segment.compact_valid_rows(
                jnp.asarray(idx), jnp.asarray(valid), out_len, pad_value=9)))
    embed = r.randn(3, 16, 8).astype(np.float32)
    code = r.randn(2, 5, 8).astype(np.float32)
    np.testing.assert_array_equal(
        quantizer.codebook_indices_from_code(quantizer.Codebook(t(embed)),
                                             t(code)).numpy(),
        np.asarray(jax_quantizer.codebook_indices_from_code(
            jax_quantizer.Codebook(jnp.asarray(embed)), jnp.asarray(code))))
