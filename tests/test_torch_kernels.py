"""Plain PyTorch versions of the port's CUDA kernels against the Pallas
kernels they replace, run in interpret mode on the CPU as the JAX package's
own kernel tests run them (tests/test_pallas_flash.py, test_fused_dit.py,
test_pallas_conv.py, test_pallas_fused_mlp.py).  Tolerance: 1e-5 abs in
float32 (same arithmetic, different summation order); the int8 / int4
kernels 1e-3 relative to the largest reference value, as the bf16 rounding
of the fused MLP's activation can differ by one step where the f32 sums
differ in the last bit.

The wrappers take the plain version for a CPU tensor and launch nothing, so
their launch counters stay at 0 here; the kernels themselves are held
against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taste_spokenlm_tpu.ops.pallas import fused_dit as jax_fused_dit
from taste_spokenlm_tpu.ops.pallas.conv1d import conv1d_same as jax_conv1d_same
from taste_spokenlm_tpu.ops.pallas import fused_mlp as jax_fused_mlp
from taste_spokenlm_tpu.ops.pallas import int4_matmul as jax_int4
from taste_spokenlm_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention)
from taste_spokenlm_tpu.utils.quant import quantize_kernel as jax_quantize_kernel
from taste_spokenlm_tpu_torch.kernels import (conv1d, flash_attention,
                                              fused_dit, fused_mlp,
                                              int4_matmul, launch_counts,
                                              reset_launch_counts)

torch.set_num_threads(2)
ATOL = 1e-5


@pytest.mark.parametrize("t,h,d,causal", [(256, 2, 64, False),
                                          (256, 2, 64, True),
                                          (200, 2, 32, False),
                                          (300, 1, 64, True)])
def test_flash_attention_plain_matches_pallas(t, h, d, causal):
    r = np.random.RandomState(0)
    q, k, v = (r.randn(2, t, h, d).astype(np.float32) for _ in range(3))
    ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, interpret=True)
    got = flash_attention.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_key_lengths_match_pallas(causal):
    """Keys padded past their true lengths: the port's kv_lengths against
    the Pallas kernel on the unpadded keys (its own valid_len mask)."""
    r = np.random.RandomState(3)
    t, h, d, lens = 300, 2, 64, (300, 173)
    q, k, v = (r.randn(2, t, h, d).astype(np.float32) for _ in range(3))
    got = flash_attention.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, kv_lengths=torch.tensor(lens))
    for bi, ln in enumerate(lens):
        ref = jax_flash_attention(jnp.asarray(q[bi:bi + 1]),
                                  jnp.asarray(k[bi:bi + 1, :ln]),
                                  jnp.asarray(v[bi:bi + 1, :ln]),
                                  causal=causal, interpret=True)
        np.testing.assert_allclose(got[bi:bi + 1].numpy(), np.asarray(ref),
                                   atol=ATOL, rtol=0)


@pytest.fixture
def interpret_fused_dit():
    jax_fused_dit._INTERPRET[0] = True
    yield
    jax_fused_dit._INTERPRET[0] = False


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _dit_params(r, c, inner):
    def w(*shape, s=0.05):
        return (r.randn(*shape) * s).astype(np.float32)
    return {
        "norm1": {"scale": 1.0 + w(c), "bias": w(c)},
        "attn1": {"to_q": {"kernel": w(c, inner)}, "to_k": {"kernel": w(c, inner)},
                  "to_v": {"kernel": w(c, inner)},
                  "to_out": {"kernel": w(inner, c), "bias": w(c)}},
        "norm3": {"scale": 1.0 + w(c), "bias": w(c)},
        "ff_in": {"kernel": w(c, 4 * c), "bias": w(4 * c)},
        "ff_out": {"kernel": w(4 * c, c), "bias": w(c)},
    }


@pytest.mark.parametrize("c,heads,t,lens", [(128, 2, 100, (100, 61)),
                                            (256, 4, 72, (50, 72))])
def test_fused_dit_plain_matches_pallas(interpret_fused_dit, c, heads, t, lens):
    r = np.random.RandomState(1)
    hd = c // heads
    params = _dit_params(r, c, heads * hd)
    x = (r.randn(2, t, c) * 0.5).astype(np.float32)
    lengths = np.asarray(lens, np.int32)
    ref = jax_fused_dit.fused_dit_block(
        jnp.asarray(x), jnp.asarray(lengths), _map(jnp.asarray, params),
        heads=heads, head_dim=hd)
    got = fused_dit.fused_dit_block(
        torch.from_numpy(x), torch.from_numpy(lengths),
        _map(torch.from_numpy, params), heads=heads, head_dim=hd)
    ref = np.asarray(ref)
    # padded query rows are junk by contract (models/flow.py _key_valid)
    for bi, ln in enumerate(lens):
        np.testing.assert_allclose(got[bi, :ln].numpy(), ref[bi, :ln],
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("t,cin,cout,k,d", [(300, 128, 128, 7, 3),
                                            (97, 128, 256, 3, 1),
                                            (260, 256, 128, 11, 5),
                                            (130, 128, 128, 11, 1)])
def test_conv1d_plain_matches_pallas(t, cin, cout, k, d):
    r = np.random.RandomState(2)
    x = r.randn(1, t, cin).astype(np.float32)
    w = (r.randn(k, cin, cout) * 0.05).astype(np.float32)
    b = r.randn(cout).astype(np.float32)
    ref = jax_conv1d_same(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          dilation=d, tile=128, interpret=True)
    got = conv1d.conv1d_same(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), dilation=d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_conv1d_rejects_asymmetric_padding():
    x = torch.zeros(1, 16, 128)
    with pytest.raises(ValueError):
        conv1d.conv1d_same(x, torch.zeros(4, 128, 128))


def test_cpu_tensors_launch_no_kernel():
    reset_launch_counts()
    q = torch.randn(1, 256, 1, 32)
    flash_attention.flash_attention(q, q, q)
    conv1d.conv1d_same(torch.randn(1, 8, 128), torch.randn(3, 128, 128))
    fused_mlp.ffn_int8(torch.randn(2, 64), torch.ones(64, 32, dtype=torch.int8),
                       torch.ones(32), torch.zeros(32),
                       torch.ones(32, 64, dtype=torch.int8), torch.ones(64),
                       torch.zeros(64))
    int4_matmul.matmul_int4(torch.randn(1, 64),
                            torch.zeros(32, 8, dtype=torch.uint8),
                            torch.ones(2, 8))
    assert launch_counts() == {"flash_attention": 0, "fused_dit_block": 0,
                               "conv1d_same": 0, "gated_mlp_int8": 0,
                               "ffn_int8": 0, "matmul_int4": 0}


def _q8(r, n_in, n_out):
    """Fan-in scaled weights through the JAX package's int8 quantizer."""
    q = jax_quantize_kernel(r.randn(n_in, n_out).astype(np.float32)
                            / np.sqrt(n_in))
    return np.array(q["base_q"]), np.array(q["base_scale"])


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("m,h,i,block", [(1, 256, 1024, 256), (5, 128, 512, 512),
                                         (256, 64, 256, 128)])
def test_gated_mlp_int8_plain_matches_pallas(m, h, i, block):
    r = np.random.RandomState(10)
    (wg, sg), (wu, su), (wd, sd) = _q8(r, h, i), _q8(r, h, i), _q8(r, i, h)
    x = r.randn(m, h).astype(np.float32)
    ref = jax_fused_mlp.gated_mlp_int8(*map(jnp.asarray, (x, wg, sg, wu, su,
                                                          wd, sd)),
                                       block_i=block, interpret=True)
    got = fused_mlp.gated_mlp_int8(*map(torch.from_numpy, (x, wg, sg, wu, su,
                                                           wd, sd)))
    assert _rel(got.numpy(), ref) <= 1e-3


@pytest.mark.parametrize("m,d,i,block,act", [(1, 128, 512, 512, "swish"),
                                             (5, 256, 1024, 256, "relu"),
                                             (256, 64, 128, 128, "swish")])
def test_ffn_int8_plain_matches_pallas(m, d, i, block, act):
    r = np.random.RandomState(11)
    (w1, s1), (w2, s2) = _q8(r, d, i), _q8(r, i, d)
    b1 = (0.1 * r.randn(i)).astype(np.float32)
    b2 = (0.1 * r.randn(d)).astype(np.float32)
    x = r.randn(2, m, d).astype(np.float32)           # leading batch dims
    args = (x, w1, s1, b1, w2, s2, b2)
    ref = jax_fused_mlp.ffn_int8(*map(jnp.asarray, args), activation=act,
                                 block_i=block, interpret=True)
    got = fused_mlp.ffn_int8(*map(torch.from_numpy, args), activation=act)
    assert got.shape == (2, m, d)
    assert _rel(got.numpy(), ref) <= 1e-3


@pytest.mark.parametrize("lead,d,n", [((1,), 256, 4097), ((2, 3), 128, 1000),
                                      ((7,), 2048, 640)])
def test_matmul_int4_plain_matches_pallas(lead, d, n):
    r = np.random.RandomState(12)
    w = (r.randn(d, n) / np.sqrt(d)).astype(np.float32)
    wp, scale = jax_int4.quantize_int4(jnp.asarray(w))
    x = r.randn(*lead, d).astype(np.float32)
    ref = jax_int4.matmul_int4(jnp.asarray(x), wp, scale, interpret=True)
    got = int4_matmul.matmul_int4(torch.from_numpy(x),
                                  torch.from_numpy(np.array(wp)),
                                  torch.from_numpy(np.array(scale)))
    assert got.shape == (*lead, n)
    assert _rel(got.numpy(), ref) <= 1e-3


def test_int4_packing_is_byte_identical_to_jax():
    r = np.random.RandomState(13)
    for d, n, group in ((256, 4097, None), (64, 300, 16), (2048, 24, None)):
        w = r.randn(d, n).astype(np.float32)
        jp, js = jax_int4.quantize_int4(jnp.asarray(w), group)
        pp, ps = int4_matmul.quantize_int4(torch.from_numpy(w), group)
        np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            int4_matmul.unpack_int4(pp).numpy(),
            np.asarray(jax_int4.unpack_int4_ref(jp)))
        np.testing.assert_array_equal(
            int4_matmul.dequantize_int4(pp, ps).numpy(),
            np.asarray(jax_int4.dequantize_int4(jp, js)))
        assert int4_matmul._group(d, group) == jax_int4._group(d, group)
    for i in (8192, 2048, 4097, 96):
        assert fused_mlp.mlp_tile(i) == jax_fused_mlp.mlp_tile(i)


@pytest.mark.parametrize("rows", [3, 300])
def test_int4_apply_dispatch_matches_jax(rows):
    """<= 256 rows take the kernel (its plain version here), more rows one
    dequantization and a plain product, on both sides."""
    from taste_spokenlm_tpu.ops.quantized import int4_apply as jax_int4_apply
    from taste_spokenlm_tpu_torch.ops.quantized import int4_apply
    r = np.random.RandomState(14)
    w = (r.randn(128, 96) / np.sqrt(128)).astype(np.float32)
    wp, scale = jax_int4.quantize_int4(jnp.asarray(w))
    x = r.randn(rows, 128).astype(np.float32)
    ref = jax_int4_apply(jnp.asarray(x), wp, scale, jnp.float32)
    got = int4_apply(torch.from_numpy(x), torch.from_numpy(np.array(wp)),
                     torch.from_numpy(np.array(scale)), torch.float32)
    assert _rel(got.numpy(), ref) <= 1e-3
