"""The port's decode-layout tools (taste_spokenlm_tpu_torch/scripts)
against the JAX scripts they port.

Each layout step of profile_fusion (A, B, P, Q, R, S, C) and each head of
profile_lmhead runs on the CPU, where the kernel wrappers take their plain
versions, against the same step written with the JAX package's functions:
XLA's GEMV (`(x.bf16 @ w.bf16) * s.bf16`), and matmul_int8, matmul_int4,
gated_mlp_int8 and gated_mlp_int4 in interpret mode.  Both sides get the
same numpy weights at tiny shapes (H 128, kv 64, I 256, a down projection
of two 128-row tiles, 2 layers, one step).  Tolerance: 1e-3 of max|JAX|,
as both sides round to bf16 at the same points and sum exact products in
f32 in another order (a rounding that flips moves the result by about one
bf16 step of one value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taste_spokenlm_tpu.ops.pallas import fused_mlp as jax_fused_mlp
from taste_spokenlm_tpu.ops.pallas import int4_matmul as jax_int4
from taste_spokenlm_tpu.ops.pallas import int8_matmul as jax_int8
from taste_spokenlm_tpu_torch.kernels import launch_counts, reset_launch_counts
from taste_spokenlm_tpu_torch.scripts import profile_fusion, profile_lmhead

torch.set_num_threads(2)
H, KV, I, TILE, LAYERS = 128, 64, 256, 128, 2
BF = jnp.bfloat16
TOL = 1e-3


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# ---- the JAX scripts' steps, over explicit weights ----


def j_gemv(x, w, s):
    return (x.astype(BF) @ w.astype(BF)) * s.astype(BF)


def j_attn(q, k, v):
    return q + jnp.pad(k + v, ((0, 0), (0, H - KV)))


def j_split(qkv):
    return qkv[:, :H], qkv[:, H:H + KV], qkv[:, H + KV:]


def j_step_a(x, ws):
    for lw in ws:
        x = x + j_gemv(j_attn(j_gemv(x, *lw[0]), j_gemv(x, *lw[1]),
                              j_gemv(x, *lw[2])), *lw[3])
        g, u = j_gemv(x, *lw[4]), j_gemv(x, *lw[5])
        x = x + j_gemv(jax.nn.silu(g) * u, *lw[6])
    return x


def j_step_b(x, ws):
    for lw in ws:
        x = x + j_gemv(j_attn(*j_split(j_gemv(x, *lw[0]))), *lw[1])
        gu = j_gemv(x, *lw[2])
        x = x + j_gemv(jax.nn.silu(gu[:, :I]) * gu[:, I:], *lw[3])
    return x


def j_fused(mm):
    def step(x, ws):
        for lw in ws:
            qkv = mm(x, *lw[0]).astype(BF)
            x = x + mm(j_attn(*j_split(qkv)), *lw[1]).astype(BF)
            gu = mm(x, *lw[2]).astype(BF)
            x = x + mm(jax.nn.silu(gu[:, :I]) * gu[:, I:], *lw[3]).astype(BF)
        return x
    return step


def j_mm8(x, w, s):
    return jax_int8.matmul_int8(x, w, s, interpret=True)


def j_mm4(x, w, s):
    return jax_int4.matmul_int4(x, w, s, interpret=True)


def j_step_r(x, ws):
    for lw in ws:
        x = x + j_gemv(j_attn(*j_split(j_gemv(x, *lw[0]))), *lw[1])
        x = x + jax_fused_mlp.gated_mlp_int8(
            x.astype(BF), *lw[2], *lw[3], *lw[4], interpret=True).astype(BF)
    return x


def j_step_s(x, ws):
    for lw in ws:
        qkv = j_mm4(x, *lw[0]).astype(BF)
        x = x + j_mm4(j_attn(*j_split(qkv)), *lw[1]).astype(BF)
        x = x + jax_fused_mlp.gated_mlp_int4(
            x.astype(BF), *lw[2], *lw[3], *lw[4], block_i=TILE,
            interpret=True).astype(BF)
    return x


def j_step_c(x, ws):
    return x + j_gemv(x, *ws)[:, :H]


JAX_STEPS = {"A": j_step_a, "B": j_step_b, "P": j_fused(j_mm8),
             "Q": j_fused(j_mm4), "R": j_step_r, "S": j_step_s,
             "C": j_step_c}


# ---- the same numpy weights for both sides ----


def _weight_sets():
    """{set key: per-layer numpy weights} in the layouts' layout, from the
    JAX recipe (int8 in [-127, 127], scales (U + 0.5) / 127, int4 from the
    int8 grid times 0.02 / 64, packed by the JAX package)."""
    r = np.random.RandomState(0)
    sep, fused = profile_fusion.shapes(H, KV, I)

    def mk(d_in, d_out):
        return (r.randint(-127, 128, (d_in, d_out)).astype(np.int8),
                ((r.rand(d_out) + 0.5) / 127.0).astype(np.float32))

    def mk4(d_in, d_out, tile=None):
        w = jnp.asarray(mk(d_in, d_out)[0].astype(np.float32) * (0.02 / 64.0))
        q = (jax_fused_mlp.quantize_int4_tiled(w, tile) if tile
             else jax_int4.quantize_int4(w))
        return tuple(np.array(t) for t in q)

    a = [[mk(*sh) for sh in sep] for _ in range(LAYERS)]
    b = [[tuple(np.concatenate(t, axis=-1) for t in zip(*lw[0:3])), lw[3],
          tuple(np.concatenate(t, axis=-1) for t in zip(*lw[4:6])), lw[6]]
         for lw in a]
    per_layer = sum(x * y for x, y in sep)
    return {"a": a, "b": b,
            "q": [[mk4(*sh) for sh in fused] for _ in range(LAYERS)],
            "r": [[b[n][0], b[n][1], a[n][4], a[n][5], a[n][6]]
                  for n in range(LAYERS)],
            "s": [[mk4(H, H + 2 * KV), mk4(H, H), mk4(H, I), mk4(H, I),
                   mk4(I, H, TILE)] for _ in range(LAYERS)],
            "c": mk(H, per_layer * LAYERS // H)}


def _map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t) for t in tree)
    return fn(tree)


@pytest.fixture(scope="module")
def weight_sets():
    return _weight_sets()


@pytest.mark.parametrize("letter,key", [(lay[0], lay[2])
                                        for lay in profile_fusion.LAYOUTS])
def test_layout_step_matches_jax(weight_sets, letter, key):
    ws = weight_sets[key]
    x0 = np.random.RandomState(1).randn(1, H).astype(np.float32)
    ref = JAX_STEPS[letter](jnp.asarray(x0), _map(jnp.asarray, ws))
    step = profile_fusion.STEPS[letter]
    kwargs = {"tile": TILE} if letter == "S" else {}
    reset_launch_counts()
    got = step(torch.from_numpy(x0), _map(torch.from_numpy, ws), **kwargs)
    assert got.shape == (1, H) and got.dtype == torch.float32
    assert np.isfinite(np.asarray(ref, np.float32)).all()
    assert _rel(got.numpy(), ref) <= TOL
    # the CPU wrappers ran their plain versions, and so did the PLAIN ops
    assert not any(launch_counts().values())
    plain = step(torch.from_numpy(x0), _map(torch.from_numpy, ws),
                 profile_fusion.PLAIN, **kwargs)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("head", ["xla", "int8", "int4"])
def test_lmhead_heads_match_jax(head):
    """The three heads on the JAX script's table, scales and h0 (V = 1000,
    ragged for the JAX block search), against XLA's dot, logits_int8 and
    matmul_int4 in interpret mode."""
    table, scale, h0, q4 = profile_lmhead.make_weights(1000, 128, 2,
                                                       torch.device("cpu"))
    tj, sj, hj = (jnp.asarray(table.numpy()), jnp.asarray(scale.numpy()),
                  jnp.asarray(h0.float().numpy()).astype(BF))
    if head == "xla":
        got = profile_lmhead.xla_head(h0, (table, scale))
        ref = jax.lax.dot_general(hj, tj.astype(BF), (((1,), (1,)), ((), ())),
                                  preferred_element_type=jnp.float32) * sj
    elif head == "int8":
        got = profile_lmhead.int8_head(h0, (table, scale))
        ref = jax_int8.logits_int8(hj, tj, sj, interpret=True)
    else:
        got = profile_lmhead.int4_head(h0, q4)
        q4j = jax_int4.quantize_int4((tj.astype(jnp.float32) * sj[:, None]).T)
        np.testing.assert_array_equal(q4[0].numpy(), np.asarray(q4j[0]))
        ref = jax_int4.matmul_int4(hj, *q4j, interpret=True)
    assert got.shape == (2, 1000) and got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= TOL
    np.testing.assert_array_equal(got.numpy().argmax(-1),
                                  np.asarray(ref).argmax(-1))


def test_profile_fusion_main_runs_on_the_cpu(capsys):
    out = profile_fusion.main(["--device", "cpu", "--h", "128", "--kv", "64",
                               "--i", "1024", "--layers", "2", "--steps", "1",
                               "--iters", "1"])
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 1 + 7 and printed[0].startswith("weights:")
    assert [ln.split()[0] for ln in printed[1:]] == list("ABPQRSC")
    assert set(out["layouts"]) == set("ABPQRSC")
    for res in out["layouts"].values():
        assert res["bound_share"] is None and res["launches"] == {}


def test_profile_lmhead_main_runs_on_the_cpu(capsys):
    out = profile_lmhead.main(["--device", "cpu", "--v", "1000", "--d", "128",
                               "--steps", "2"])
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 3 + 2
    assert printed[3].startswith("parity int8") and printed[4].startswith(
        "parity int4")
    assert out["parity_int8"]["rel_err"] <= TOL
    assert out["parity_int8"]["argmax_agree"] == 1.0


@pytest.mark.parametrize("tool", [profile_fusion, profile_lmhead])
def test_tools_need_cuda_unless_asked_for_the_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(["--steps", "1"])
