"""Plain PyTorch versions of the port's CUDA kernels against the Pallas
kernels they replace, run in interpret mode on the CPU as the JAX package's
own kernel tests run them (tests/test_pallas_flash.py, test_fused_dit.py,
test_pallas_conv.py).  Tolerance: 1e-5 abs in float32 (same arithmetic,
different summation order).

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
from taste_spokenlm_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention)
from taste_spokenlm_tpu_torch.kernels import (conv1d, flash_attention,
                                              fused_dit, launch_counts,
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
    assert launch_counts() == {"flash_attention": 0, "fused_dit_block": 0,
                               "conv1d_same": 0}
