"""The model variants of the PyTorch port against the JAX package, on the
CPU: the word-remap and alignment-pooling ops, padded flash attention's
plain version against JAX's Pallas path in interpret mode, grouped-query
attention, the quantizer zoo (eval and train), the
conformer's conv module, macaron FFN and conv stems (BatchNorm statistics
after a train step, each stem's length mapping).  The bridges and the
spoken LM's variants are in test_torch_spoken_variants.py, the speech
decoder's fusions and the audio tower's variants in
test_torch_decoder_variants.py.  Weights cross through
taste_spokenlm_tpu_torch.convert, strict.

Tolerances: f32 floats 1e-4 relative to the reference's max |value|; ids,
RVQ indices and trajectories exact; the bf16 attention 2e-2.  Wall: about
35 s on one worker (python -m pytest tests/test_torch_variants.py -q).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taste_spokenlm_tpu_torch import convert
from torch_parity_common import (dead_picks, fill_params, jit_apply, rel_err,
                                 t)

torch.set_num_threads(2)
TOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["cross_tokenizer_remap", "alignment_mean_pool"])
def test_segment_ops_match_jax(op):
    from taste_spokenlm_tpu.ops import segment as js
    from taste_spokenlm_tpu_torch.ops import segment as ps
    r = np.random.RandomState(0)
    if op == "cross_tokenizer_remap":
        args = (np.array([[0, 0, 1, 2, 2, 3, 0, 0], [0, 1, 1, 2, 3, 3, 4, 4]]),
                np.array([6, 8]),
                np.array([[0, 1, 1, 2, 3, 3, 3, 0, 0], [0, 0, 1, 2, 2, 3, 4, 0, 0]]),
                np.array([7, 7]))
    else:
        al = np.sort(r.rand(2, 5, 2), axis=-1).astype(np.float32)
        args = (r.randn(2, 20, 6).astype(np.float32), np.array([20, 14]),
                al, np.array([5, 3]))
    ref = np.asarray(getattr(js, op)(*map(jnp.asarray, args)))
    got = getattr(ps, op)(*map(t, args)).numpy()
    if op == "cross_tokenizer_remap":
        np.testing.assert_array_equal(got, ref)
        assert ref.sum() > 0
    else:
        assert rel_err(got, ref) <= TOL
        assert np.abs(ref).max() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_flash_plain_matches_pallas_interpret(dtype):
    """The CPU path against JAX's padded_flash_attention (the Pallas kernel
    in interpret mode, its mask lane) on the valid query rows of rows with
    a valid key; a row with no valid key stays finite."""
    from taste_spokenlm_tpu.ops.attention import padded_flash_attention as jp
    from taste_spokenlm_tpu_torch.ops.attention import padded_flash_attention
    r = np.random.RandomState(1)
    b, tq, h, d = 3, 130, 2, 16
    q, k, v = (r.randn(b, tq, h, d).astype(np.float32) for _ in range(3))
    lens = np.array([tq, tq - 37, 0])
    key_valid = np.arange(tq)[None, :] < lens[:, None]
    jdt = jnp.dtype(dtype)
    ref = np.asarray(jp(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                        jnp.asarray(key_valid), interpret=True), np.float32)
    tdt = getattr(torch, dtype)
    got = padded_flash_attention(t(q, tdt), t(k, tdt), t(v, tdt),
                                 t(key_valid)).float().numpy()
    assert np.isfinite(got).all()
    tol = TOL if dtype == "float32" else 2e-2
    for i in range(2):
        assert rel_err(got[i, :lens[i]], ref[i, :lens[i]]) <= tol


@pytest.mark.parametrize("mask", ["none", "shared", "per_head"])
def test_gqa_attention_matches_jax(mask):
    from taste_spokenlm_tpu.ops.attention import gqa_attention as jg
    from taste_spokenlm_tpu_torch.ops.attention import gqa_attention
    r = np.random.RandomState(2)
    q = r.randn(2, 5, 4, 8).astype(np.float32)
    k, v = (r.randn(2, 7, 2, 8).astype(np.float32) for _ in range(2))
    m = None
    if mask != "none":
        m = r.rand(2, 1 if mask == "shared" else 4, 5, 7) > 0.3
        m[..., 0] = True
    ref = jg(*map(jnp.asarray, (q, k, v)),
             None if m is None else jnp.asarray(m), scale=0.3)
    got = gqa_attention(t(q), t(k), t(v), None if m is None else t(m),
                        scale=0.3)
    assert rel_err(got.numpy(), ref) <= TOL


# ---------------------------------------------------------------------------
# the quantizer zoo
# ---------------------------------------------------------------------------


ZOO = [("rvq", "eval"), ("vq", "eval"), ("vq", "train"),
       ("grouped_rvq", "eval"), ("grouped_rvq", "train"), ("kmeans", "eval"),
       ("no", "eval"), ("no_kmeans", "eval")]


@pytest.mark.parametrize("kind,mode", ZOO)
def test_quantizer_zoo_matches_jax(kind, mode):
    """Each quantizer of QUANTIZER_CLASSES: indices exact, features and
    commit loss 1e-4; in train mode the EMA buffers after the update too.
    The grouped RVQ draws a quantize-dropout level per group (JAX folds
    the key with the group; the reference shares one level): the port
    mirrors JAX, each group's draws computed from its folded key."""
    from taste_spokenlm_tpu.config import QuantizerConfig as JQ
    from taste_spokenlm_tpu.models import quantizer as jq
    from taste_spokenlm_tpu_torch.config import QuantizerConfig
    from taste_spokenlm_tpu_torch.models import quantizer as pq
    cfg_kw = dict(dim=24, codebook_dim=8, codebook_size=16, num_quantizers=3,
                  groups=2 if kind == "grouped_rvq" else 1)
    jcfg, pcfg = JQ.tiny().replace(**cfg_kw), QuantizerConfig.tiny().replace(**cfg_kw)
    r = np.random.RandomState(3)
    x = r.randn(2, 9, jcfg.dim).astype(np.float32)
    mask = np.ones((2, 9), bool)
    mask[1, 6:] = False
    base = kind.split("_")[0] if kind.startswith("no") else kind
    if base == "kmeans":
        jmod = jq.KmeansQuantizer(jcfg.codebook_size, jcfg.dim)
        pmod = pq.KmeansQuantizer(jcfg.codebook_size, jcfg.dim)
    elif base == "no":
        size = jcfg.codebook_size if kind == "no_kmeans" else 0
        jmod = jq.NoQuantizer(jcfg.dim, jcfg.codebook_dim, size)
        pmod = pq.NoQuantizer(jcfg.dim, jcfg.codebook_dim, size)
    else:
        jmod = jq.QUANTIZER_CLASSES[kind](jcfg)
        pmod = pq.QUANTIZER_CLASSES[kind](pcfg)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(mask))
    params = fill_params(shapes["params"], 4) if "params" in shapes else {}
    if "codebook" in params:     # codes on the scale of what they snap
        params["codebook"] = params["codebook"] * np.float32(
            0.5 if base == "no" else 1.0)
    quantizer = {}
    if "quantizer" in shapes:
        def fill(path, leaf):
            name = str(path[-1].key)
            shape = leaf.shape
            if name == "embed":
                return (0.3 * r.randn(*shape)).astype(np.float32)
            if name == "cluster_size":
                return (0.5 + 3 * r.rand(*shape)).astype(np.float32)
            if name == "initted":
                return np.ones(shape, bool)
            return (0.3 * r.randn(*shape)).astype(np.float32)
        quantizer = jax.tree_util.tree_map_with_path(fill, shapes["quantizer"])
    variables = {"params": params}
    if quantizer:
        variables["quantizer"] = quantizer
    sd = convert.quantizer_state(base, params, quantizer)
    pmod.load_state_dict(convert.to_torch(sd), strict=True)

    train = mode == "train"
    key = jax.random.PRNGKey(7)
    kw = {}
    if train:
        if kind == "vq":
            sub = pcfg.replace(num_quantizers=1, quantize_dropout=False)
            kw = {"drop_after": None,
                  "dead_picks": t(dead_picks(key, mask, None, sub))}
        else:
            sub = pcfg.replace(dim=pcfg.dim // pcfg.groups, groups=1)
            draws = []
            for g in range(pcfg.groups):
                kg = jax.random.fold_in(key, g)
                drop = int(jax.random.randint(
                    kg, (), sub.quantize_dropout_cutoff_index,
                    sub.num_quantizers))
                draws.append({"drop_after": drop,
                              "dead_picks": t(dead_picks(kg, mask, drop, sub))})
            kw = {"draws": draws}
    ref, new_state = jmod.apply(
        variables, jnp.asarray(x), jnp.asarray(mask), train=train,
        dropout_rng=key if train else None, mutable=["quantizer"])
    got = pmod(t(x), t(mask), train=train, **kw)
    if "quantized_indices" in ref:
        np.testing.assert_array_equal(got["quantized_indices"].numpy(),
                                      np.asarray(ref["quantized_indices"]))
    assert rel_err(got["quantized_feats"].detach().numpy(),
                   ref["quantized_feats"]) <= TOL
    assert abs(float(got["commit_loss"].detach()) - float(ref["commit_loss"])) <= \
        TOL * max(1.0, abs(float(ref["commit_loss"])))
    if train:
        want = convert.quantizer_state(kind, params, _np_tree(
            new_state["quantizer"]))
        have = pmod.state_dict()
        for k2, v in want.items():
            assert rel_err(have[k2].numpy(), v) <= TOL, k2
    if kind == "grouped_rvq" and not train:
        idx = got["quantized_indices"]
        out = pmod.get_output_from_indices(idx.clamp(min=0))
        ref_out = jmod.apply(variables, jnp.asarray(idx.clamp(min=0).numpy()),
                             method=jq.GroupedResidualVQ.get_output_from_indices)
        assert rel_err(out.detach().numpy(), ref_out) <= TOL


def test_codebook_distributed_codes_matches_jax():
    from taste_spokenlm_tpu.models import quantizer as jq
    from taste_spokenlm_tpu_torch.models import quantizer as pq
    r = np.random.RandomState(5)
    embed = r.randn(3, 16, 8).astype(np.float32)
    logits = (3 * r.randn(2, 4, 3, 16)).astype(np.float32)
    ref = jq.codebook_distributed_codes(jq.Codebook(jnp.asarray(embed)),
                                        jnp.asarray(logits))
    got = pq.codebook_distributed_codes(pq.Codebook(t(embed)), t(logits))
    assert rel_err(got.numpy(), ref) <= TOL


# ---------------------------------------------------------------------------
# the conformer: conv module, macaron FFN, conv stems
# ---------------------------------------------------------------------------

CONFORMERS = [("linear", "batch_norm", False, True),
              ("linear", "layer_norm", True, False),
              ("conv1d2", "batch_norm", False, True),
              ("conv2d", "batch_norm", False, True),
              ("conv2d4", "layer_norm", True, True),
              ("conv2d6", "batch_norm", True, False),
              ("conv2d8", "batch_norm", False, True)]


@pytest.mark.parametrize("stem,norm,causal,macaron", CONFORMERS)
def test_conformer_variant_matches_jax(stem, norm, causal, macaron):
    """The stack with the conv module (BatchNorm or LayerNorm, causal or
    centred) and the macaron FFN under each input layer: the eval forward
    on ragged lengths, the stem's frame count and length mapping, and for
    BatchNorm a train forward and the running statistics it leaves."""
    from taste_spokenlm_tpu.config import EncoderStackConfig as JE
    from taste_spokenlm_tpu.models.conformer import ConformerEncoder as JC
    from taste_spokenlm_tpu_torch.config import EncoderStackConfig
    from taste_spokenlm_tpu_torch.models.conformer import ConformerEncoder
    kw = dict(input_layer=stem, use_cnn_module=True, cnn_module_norm=norm,
              cnn_causal=causal, macaron_style=macaron, cnn_module_kernel=5)
    jcfg, pcfg = JE.tiny().replace(**kw), EncoderStackConfig.tiny().replace(**kw)
    r = np.random.RandomState(8)
    t_in = 40
    x = r.randn(2, t_in, jcfg.input_size).astype(np.float32)
    lens = np.array([t_in, 29], np.int32)
    jmod = JC(jcfg)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(lens))
    params = fill_params(shapes["params"], 9)
    bstats = jax.tree_util.tree_map_with_path(
        lambda p, s: (0.5 + r.rand(*s.shape) if p[-1].key == "var"
                      else 0.1 * r.randn(*s.shape)).astype(np.float32),
        shapes.get("batch_stats", {}))
    variables = {"params": params}
    if bstats:
        variables["batch_stats"] = bstats
    port = ConformerEncoder(pcfg)
    port.load_state_dict(convert.to_torch(convert.conformer_state(
        params, "", bstats or None)), strict=True)
    ref = jit_apply(jmod, variables, jnp.asarray(x), jnp.asarray(lens))
    with torch.no_grad():
        got = port(t(x), t(lens).long())
    t_out = port.subsampled_length(t_in)
    assert got.shape[1] == t_out == ref.shape[1] == jmod.subsampled_length(t_in)
    assert rel_err(got.numpy(), ref) <= TOL
    want = jmod.apply(variables, jnp.arange(t_in + 1), t_in, t_out,
                      method=JC._subsample_lengths)
    np.testing.assert_array_equal(
        port.subsample_lengths(torch.arange(t_in + 1), t_in, t_out).numpy(),
        np.asarray(want))
    if norm != "batch_norm":
        return
    ref, new = jit_apply(jmod, variables, jnp.asarray(x), jnp.asarray(lens),
                       train=True, mutable=["batch_stats"])
    got = port(t(x), t(lens).long(), train=True)
    assert rel_err(got.detach().numpy(), ref) <= TOL
    want = convert.conformer_state(params, "", _np_tree(new["batch_stats"]))
    have = port.state_dict()
    for k2, v in want.items():
        if k2.endswith(("running_mean", "running_var")):
            assert rel_err(have[k2].numpy(), v) <= TOL, k2
            assert rel_err(v, convert.conformer_state(
                params, "", bstats)[k2]) > 1e-3       # the statistics moved
