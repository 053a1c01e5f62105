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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taste_spokenlm_tpu.ops.pallas import fused_dit as jax_fused_dit
from taste_spokenlm_tpu.ops.pallas.conv1d import conv1d_same as jax_conv1d_same
from taste_spokenlm_tpu.ops.pallas import fused_mlp as jax_fused_mlp
from taste_spokenlm_tpu.ops.pallas import int4_matmul as jax_int4
from taste_spokenlm_tpu.ops.pallas import int8_matmul as jax_int8
from taste_spokenlm_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention)
from taste_spokenlm_tpu.ops.pallas import relpos_attention as jax_relpos
from taste_spokenlm_tpu.utils.quant import quantize_kernel as jax_quantize_kernel
from taste_spokenlm_tpu_torch.kernels import (conv1d, flash_attention,
                                              fused_dit, fused_mlp,
                                              int4_matmul, int8_matmul,
                                              launch_counts, relpos_attention,
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


@pytest.mark.parametrize("t,c,k,d", [(300, 128, 7, 3), (130, 256, 11, 1)])
def test_conv1d_plain_bf16_bias_matches_pallas(t, c, k, d):
    """bf16 in and out, as the HiFT path runs: the f32 sum is cast to bf16
    once and the f32 bias is added to that in bf16 (the JAX wrapper's
    y + b.astype(y.dtype)), the cast points the kernel's fused epilogue
    keeps.  Within one bf16 step of max|ref|, and the same bits nearly
    everywhere; the bias added to the f32 sum before the one cast gives
    other bits at many elements, so the check tells the two apart."""
    r = np.random.RandomState(22)
    x = r.randn(1, t, c).astype(np.float32)
    w = (r.randn(k, c, c) * 0.05).astype(np.float32)
    b = r.randn(c).astype(np.float32)
    ref = np.asarray(jax_conv1d_same(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(b), dilation=d, tile=128, interpret=True
    ).astype(jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    got = conv1d.conv1d_same(xt, wt, torch.from_numpy(b), dilation=d)
    assert got.dtype == torch.bfloat16 and got.shape == (1, t, c)
    got = got.float().numpy()
    assert np.abs(got - ref).max() <= 2.0 ** -7 * np.abs(ref).max()
    assert (got == ref).mean() >= 0.999
    acc = conv1d.conv1d_same_plain(xt.float(), wt.float(), dilation=d)
    bias = torch.from_numpy(b).to(torch.bfloat16).float()
    one_cast = (acc + bias).to(torch.bfloat16).float().numpy()
    assert (one_cast == ref).mean() < 0.9


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
    packed = torch.zeros(32, 64, dtype=torch.uint8)
    fused_mlp.gated_mlp_int4(torch.randn(1, 64), packed, torch.ones(2, 64),
                             packed, torch.ones(2, 64), packed,
                             torch.ones(2, 64))
    fused_mlp.ffn_int4(torch.randn(3, 64), packed, torch.ones(2, 64),
                       torch.zeros(64), packed, torch.ones(2, 64),
                       torch.zeros(64))
    xs = [torch.randn(1, 300, 1, 128, requires_grad=True) for _ in range(4)]
    xs.append(torch.randn(599, 1, 128, requires_grad=True))
    relpos_attention.relpos_causal_attention(*xs).sum().backward()
    int8_matmul.logits_int8(torch.randn(2, 64),
                            torch.ones(40, 64, dtype=torch.int8),
                            torch.ones(40))
    int8_matmul.matmul_int8(torch.randn(1, 64),
                            torch.ones(64, 40, dtype=torch.int8),
                            torch.ones(40))
    assert launch_counts() == {"flash_attention": 0, "fused_dit_block": 0,
                               "conv1d_same": 0, "gated_mlp_int8": 0,
                               "ffn_int8": 0, "gated_mlp_int4": 0,
                               "ffn_int4": 0, "matmul_int4": 0,
                               "relpos_causal_attention": 0,
                               "relpos_causal_attention_bwd": 0,
                               "logits_int8": 0, "matmul_int8": 0}


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


@pytest.mark.parametrize("m,d,n,group,sms", [
    (1, 1024, 1024, 128, 132), (1, 1024, 3072, 128, 132),
    (1, 1024, 4096, 128, 132), (1, 2048, 1024, 128, 132),
    (1, 2048, 3072, 128, 132), (1, 8192, 2048, 128, 132),
    (1, 2048, 16384, 128, 132), (1, 2048, 128256, 128, 132),
    (1, 256, 4097, 128, 132),        # D/2 is one group
    (1, 2048, 1024, 128, 1),         # one SM: the widest lanes, one slice
    (3, 512, 1000, 128, 132), (8, 2048, 4096, 128, 132),
    (1, 100, 64, 50, 132),           # a group that is no power of two
    (2, 6144, 1024, 96, 16)])
def test_matmul_int4_split_plan(m, d, n, group, sms):
    """The split kernel's plan: a lane width that fits MT rows of x, and
    slices of the packed rows that are whole scale groups covering [0, D/2)
    in order; one slice where D/2 is one group; at M = 1 in blocks of 512
    threads, at most 16 rows a lane and one block a SM, else in blocks of
    128, one slice where the column tiles alone fill the card, and
    otherwise within 2x of four blocks a SM."""
    half, n_g = d // 2, d // 2 // group
    cols, threads, rows = int4_matmul.split_plan(m, d, n, group, sms)
    mt = 1 if m == 1 else 2 if m == 2 else 4
    assert cols in (4, 8, 16) and cols * mt <= 16
    assert threads == 128 or (threads == int4_matmul.WIDE_THREADS and m == 1)
    assert rows % group == 0 and group <= rows
    n_split = -(-half // rows)
    bounds = [(s * rows, min((s + 1) * rows, half)) for s in range(n_split)]
    assert bounds[0][0] == 0 and bounds[-1][1] == half
    assert all(r0 < r1 and r0 % group == 0 and r1 % group == 0
               for r0, r1 in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    tiles = -(-n // (8 * cols)) * -(-m // mt)
    assert n_split == 1 or tiles <= int4_matmul.MAX_ARRIVALS
    if n_g == 1:
        assert n_split == 1
    if threads != 128:
        assert tiles * n_split <= sms
        assert rows <= threads // 8 * 16 or rows == group
    elif tiles >= 4 * sms:
        assert n_split == 1
    else:
        assert 2 * tiles * n_split >= min(4 * sms, tiles * n_g)


@pytest.mark.parametrize("m,d,n,sms", [
    (1, 1024, 1024, 132), (1, 1024, 3072, 132), (1, 1024, 4096, 132),
    (1, 2048, 1024, 132), (1, 2048, 2048, 132), (1, 2048, 3072, 132),
    (1, 8192, 2048, 132), (1, 2048, 16384, 132),   # the path's M = 1 shapes
    (1, 2048, 16384, 114), (1, 8192, 2048, 114), (1, 1024, 4096, 114),
    (1, 2048, 2048, 114),
    (1, 2048, 128256, 132),          # more tiles than SMs
    (1, 2048, 1024, 1),              # one SM
    (1, 100, 64, 132), (1, 16, 8, 132),
    (8, 1024, 1024, 132), (8, 8192, 2048, 114), (2, 100, 1000, 132),
    (3, 2048, 3072, 132), (5, 2048, 16384, 132),
    (13, 2048, 2048, 132), (200, 8192, 2048, 132), (4096, 2048, 16384, 132)])
def test_matmul_int8_split_plan(m, d, n, sms):
    """matmul_int8's plan: a lane width that fits MT rows of x, slices that
    are multiples of a lane's row step and cover [0, D) in order, and a
    split only where its column and row tiles have arrival counters.  At
    M = 1: one slice up to D = 1024, and at D <= 2048 where the 4-byte
    lanes' tiles fill half the card, the narrowest lanes that fit one wave;
    D = 8192 splits, in 16-byte lanes, tiles times slices within one wave
    and at most 32 rows a lane.  At M > 1 blocks of 128 and about four
    blocks a SM."""
    cols, threads, rows = int8_matmul.split_plan(m, d, n, sms)
    mt = 1 if m == 1 else 2 if m == 2 else 4
    assert cols in (4, 8, 16) and cols * mt <= 16
    assert threads in (128, 256, 512, 1024) and (threads < 1024 or cols < 16)
    assert rows % int8_matmul.ROW_STEP == 0 and rows > 0
    n_split = -(-d // rows)
    bounds = [(s * rows, min((s + 1) * rows, d)) for s in range(n_split)]
    assert bounds[0][0] == 0 and bounds[-1][1] == d
    assert all(r0 < r1 for r0, r1 in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    tiles = -(-n // (8 * cols)) * -(-m // mt)
    assert n_split == 1 or tiles <= int8_matmul.MAX_ARRIVALS
    if m == 1:
        if d <= 1024 or (d <= 2048 and 2 * -(-n // 32) >= sms):
            assert n_split == 1
            assert tiles <= sms or cols == 16
            assert cols == 4 or -(-n // (4 * cols)) > sms
        if d == 8192 and sms >= 2 * tiles:
            assert n_split > 1
        if n_split > 1:
            assert cols == 16 and tiles * n_split <= sms
            assert n_split <= int8_matmul.SPLIT_SLICES
            assert rows <= threads // 8 * 32
    else:
        assert threads == 128
        if tiles >= 4 * sms:
            assert n_split == 1
        else:
            assert 2 * tiles * n_split >= min(4 * sms, tiles * -(-d // 8))


# the gated kernels' plan: (kind, M, H, I, SMs); the Llama and S3 shapes of
# the path at 132 and 114 SMs, prefill rows, and tiny widths
@pytest.mark.parametrize("kind,m,h,i,sms", [
    ("int8", 1, 2048, 8192, 132), ("int8", 42, 2048, 8192, 132),
    ("int8", 1, 1024, 2048, 132), ("int8", 256, 2048, 8192, 132),
    ("int8", 1, 2048, 8192, 114), ("int8", 1, 1024, 2048, 114),
    ("int8", 3, 256, 1024, 132), ("int8", 1, 64, 96, 132),
    ("int8", 2, 8, 32, 132),
    ("int4", 1, 2048, 8192, 132), ("int4", 42, 2048, 8192, 132),
    ("int4", 1, 1024, 2048, 132), ("int4", 256, 2048, 8192, 132),
    ("int4", 1, 2048, 8192, 114), ("int4", 1, 1024, 2048, 114),
    ("int4", 3, 256, 1024, 132), ("int4", 5, 64, 128, 132),
    ("int4", 2, 32, 64, 132)])
def test_gated_mlp_plan(kind, m, h, i, sms):
    """The gated kernels' plan.  One row with H % 16 == 0: the SIMT kernel,
    clusters of GEMV_CLUSTER blocks (fewer where H has fewer 16-column
    chunks), as many clusters as fill 10/11 of the SMs (120 of an H100's
    132: the SMs that clusters of 8 reach, timed on the card) and at most
    one per 16-column chunk.  Otherwise the tensor cores: a cluster and a
    column width the kernel takes, every rank with contraction rows and
    128, 256 or 512 output columns, arrival counters for every rank and row tile,
    slots that cover I (int4: each inside one tile of Wd), and no candidate
    with more blocks (row tiles counted) that still fit on the card in one
    wave; where none fits, none with fewer blocks."""
    int4 = kind == "int4"
    tile = fused_mlp.mlp_tile(i) if int4 else None
    cluster, cols, slots = fused_mlp.gated_plan(m, h, i, sms, tile)
    assert cluster in fused_mlp.GATED_CLUSTERS
    k1 = h // 2 if int4 else h
    if m == 1 and h % 16 == 0:
        chunks = i // 32 if int4 else i // 16
        assert cluster == min(fused_mlp.GEMV_CLUSTER, h // 16)
        assert slots == max(1, min(chunks, sms * 10 // 11 // cluster))
        if (h, i) in ((2048, 8192), (1024, 2048)):
            assert slots * cluster == (120 if sms == 132 else 96)
        return
    assert slots == 0
    assert cols in fused_mlp.GATED_COLS

    def ranks_ok(cl):
        kc = -(-(-(-k1 // cl)) // 16) * 16
        hc = -(-(-(-h // cl)) // 128) * 128
        return (kc * (cl - 1) < k1 and hc * (cl - 1) < h
                and hc in (128, 256, 512))

    assert ranks_ok(cluster)
    assert -(-m // fused_mlp.GATED_ROWS) * cluster <= fused_mlp.MAX_ARRIVALS
    slots = fused_mlp.gated_clusters(i, cols, tile)
    if int4:
        per_tile = -(-(tile // 2) // (cols // 2))
        assert slots == i // tile * per_tile
        assert (per_tile - 1) * cols // 2 < tile // 2 <= per_tile * cols // 2
    else:
        assert (slots - 1) * cols < i <= slots * cols
    tiles = -(-m // fused_mlp.GATED_ROWS)
    blocks = slots * cluster * tiles
    for cl in fused_mlp.GATED_CLUSTERS:
        for co in fused_mlp.GATED_COLS:
            more = fused_mlp.gated_clusters(i, co, tile) * cl * tiles
            if ranks_ok(cl) and blocks <= sms:
                assert not blocks < more <= sms
            elif ranks_ok(cl):          # none fits in one wave: the fewest
                assert more >= blocks
    if (h, i) == (2048, 8192) and sms == 132:   # the prefill, timed
        assert (cluster, cols) == (4, 256)


# ffn_int8 on the gated kernels: (M, H, I, SMs) -> (plan, partial-sum
# slots); the S3 stack's FFN at decode (M = 1) and at the 131-row prefill,
# at 132 and 114 SMs, and a tiny width
@pytest.mark.parametrize("m,h,i,sms,plan,slots", [
    (1, 1024, 2048, 132, (8, 128, 15), 15),
    (131, 1024, 2048, 132, (2, 256, 0), 8),
    (1, 1024, 2048, 114, (8, 128, 12), 12),
    (131, 1024, 2048, 114, (2, 256, 0), 8),
    (2, 32, 64, 132, (1, 128, 0), 1)])
def test_ffn_int8_plan(m, h, i, sms, plan, slots):
    """ffn_int8 takes gated_plan's plan (one first-projection matrix in
    place of two changes each block's bytes, not its blocks or slots): at
    one row the SIMT kernel on 15 clusters of 8 (12 on 114 SMs), at 131 rows
    nine 16-row tiles, for which no plan fits in one wave, so the fewest
    blocks: 2-block clusters over 256 columns of I (144 blocks), and the
    partial sums' slots those plans leave; every rule of the gated plan
    holds too."""
    assert fused_mlp.gated_plan(m, h, i, sms) == plan
    cluster, cols, simt = plan
    assert (simt or fused_mlp.gated_clusters(i, cols)) == slots
    test_gated_mlp_plan("int8", m, h, i, sms)


# ffn_int4 on the gated kernels: (M, H, I, SMs) -> (plan, partial-sum
# slots, the last slot's first packed row of W2); as test_ffn_int8_plan,
# W2 packed per tile of mlp_tile(I) = 512 rows (64 at the tiny width)
@pytest.mark.parametrize("m,h,i,sms,plan,slots,row", [
    (1, 1024, 2048, 132, (8, 128, 15), 15, 944),
    (131, 1024, 2048, 132, (2, 256, 0), 8, 896),
    (1, 1024, 2048, 114, (8, 128, 12), 12, 928),
    (131, 1024, 2048, 114, (2, 256, 0), 8, 896),
    (2, 32, 64, 132, (1, 128, 0), 1, 0)])
def test_ffn_int4_plan(m, h, i, sms, plan, slots, row):
    """ffn_int4 takes gated_plan's int4 plan: at one row the SIMT kernel on
    15 clusters of 8 (12 on 114 SMs), each owning a balanced range of the
    I/32 chunks of 16 packed rows; at 131 rows, where no plan fits in one
    wave, 2-block clusters over 256 columns of I, two clusters a tile of
    W2 (144 blocks).  The last slot starts at the packed row the kernel's
    geometry derives (tsk_ffn_geometry_int4, held equal on the card), and
    under the per-tile pairing that row's low and high nibbles are the I
    rows t*tile + r and t*tile + tile/2 + r of one tile t, which also holds
    every row the slot owns on the tensor cores."""
    tile = fused_mlp.mlp_tile(i)
    assert fused_mlp.gated_plan(m, h, i, sms, tile) == plan
    cluster, cols, simt = plan
    assert (simt or fused_mlp.gated_clusters(i, cols, tile)) == slots
    half = tile // 2
    if simt:
        chunks = i // 32                       # 16 packed rows each
        first = 16 * ((slots - 1) * chunks // slots)
        last = i // 2 - 1
    else:
        per_tile = -(-half // (cols // 2))
        s = slots - 1
        first = s // per_tile * half + s % per_tile * (cols // 2)
        last = first + min(cols // 2, half - s % per_tile * (cols // 2)) - 1
        assert last // half == first // half   # one tile of W2
    assert first == row and last == i // 2 - 1
    t, r = divmod(first, half)
    low, high = t * tile + r, t * tile + half + r
    assert (low, high) == ((i - tile + r), (i - half + r))
    test_gated_mlp_plan("int4", m, h, i, sms)


def _lop3(a, b, c, lut):
    """PTX lop3.b32 on int64 tensors of 32-bit words: bit j of the result
    is bit ((a_j << 2) | (b_j << 1) | c_j) of lut."""
    out = torch.zeros_like(a)
    for j in range(32):
        idx = (((a >> j) & 1) << 2) | (((b >> j) & 1) << 1) | ((c >> j) & 1)
        out |= ((lut >> idx) & 1) << j
    return out


def _bf16_halves(w):
    """The two bf16 halves of 32-bit words, as float32 (low, high)."""
    lo = (w & 0xFFFF).to(torch.int32).to(torch.int16).view(torch.bfloat16)
    hi = ((w >> 16) & 0xFFFF).to(torch.int32).to(torch.int16).view(
        torch.bfloat16)
    return lo.float(), hi.float()


def _bf16_sub(w, v):
    """bf16x2 w - v (as __hsub2 rounds: to bf16), per half, as float32."""
    wl, wh = _bf16_halves(w)
    vl, vh = _bf16_halves(v)
    return ((wl.bfloat16() - vl.bfloat16()).float(),
            (wh.bfloat16() - vh.bfloat16()).float())


def _deq8(r, bias=0x43004300):
    """csrc/gated_mlp.cuh deq8 on words r: bytes 0 and 2 as bf16 values."""
    v = _lop3(r, torch.full_like(r, 0x007F007F), torch.full_like(r, bias),
              0xEA)
    s = _lop3(r, torch.full_like(r, 0x00800080), torch.full_like(r, 0x43004300),
              0xEA)
    return _bf16_sub(v, s)


def _deq4(r, k=0x43084308):
    """csrc/gated_mlp.cuh deq4 on words r: the low nibbles of bytes 0 and
    2 as bf16 values."""
    kk = torch.full_like(r, k)
    v = _lop3(r, torch.full_like(r, 0x000F000F), kk, 0x6A)
    return _bf16_sub(v, torch.full_like(r, 0x43084308))


def test_gated_mlp_dequant_bit_arithmetic():
    """Checks the design of the gated kernels' weight decode, not the kernel
    (which runs only on the card): a test-local copy of its bit arithmetic
    (lop3 with the kernel's lookup tables, the bf16 subtraction) gives every
    int8 byte and every nibble of both planes its integer value exactly, in
    each byte position the kernel reads (bytes 0 / 2, and 1 / 3 after a shift
    by 8; high nibbles after a shift by 4), and an offset off by one does
    not.  Its runtime divisions (FastDiv: l = ceil(log2 d), m =
    floor(2^32 (2^l - d) / d) + 1 as make_fastdiv sets them, n / d as
    (umulhi(n, m) + n) >> l) are exact for every n tried below 2^31."""
    r = np.random.RandomState(0)
    perm = np.stack([r.permutation(256) for _ in range(4)], axis=1)
    b = torch.from_numpy(perm.astype(np.int64))             # [256, 4] bytes
    words = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    as_int8 = b.to(torch.uint8).view(torch.int8).float()
    # int8: bytes 0 / 2, then 1 / 3
    for shift, (p, q) in ((0, (0, 2)), (8, (1, 3))):
        lo, hi = _deq8(words >> shift)
        assert torch.equal(lo, as_int8[:, p]) and torch.equal(hi, as_int8[:, q])
    # every byte value in every position
    assert all(sorted(perm[:, j].tolist()) == list(range(256)) for j in range(4))
    lo, hi = _deq8(words, bias=0x43014301)
    assert not torch.equal(lo, as_int8[:, 0])
    # int4: low plane (shift 0, 8) and high plane (shift 4, 12)
    nib_lo = ((b & 0xF) ^ 8) - 8
    nib_hi = (((b >> 4) & 0xF) ^ 8) - 8
    for shift, plane, (p, q) in ((0, nib_lo, (0, 2)), (8, nib_lo, (1, 3)),
                                 (4, nib_hi, (0, 2)), (12, nib_hi, (1, 3))):
        lo, hi = _deq4(words >> shift)
        assert torch.equal(lo, plane[:, p].float())
        assert torch.equal(hi, plane[:, q].float())
    assert set(nib_lo[:, 0].tolist()) == set(range(-8, 8))
    lo, _ = _deq4(words, k=0x43094309)
    assert not torch.equal(lo, nib_lo[:, 0].float())
    top = (1 << 31) - 1
    for d in (1, 2, 3, 7, 15, 16, 30, 120, 255, 4096, 123457):
        l = (d - 1).bit_length()
        mul = ((1 << 32) * ((1 << l) - d)) // d + 1
        n = np.concatenate([np.arange(5000), r.randint(0, top, 5000),
                            [top, top - 1, top // d * d, top // d * d - 1]]
                           ).astype(np.uint64)
        got = (((n * np.uint64(mul)) >> np.uint64(32)) + n) >> np.uint64(l)
        np.testing.assert_array_equal(got, n // np.uint64(d))


def _int8_inputs(seed, lead, n_w, d_w, n_scale):
    r = np.random.RandomState(seed)
    x = (r.randn(*lead) * 0.1).astype(np.float32)
    w_q = r.randint(-127, 128, (n_w, d_w)).astype(np.int8)
    scale = (np.abs(r.randn(n_scale)) * 0.01 + 1e-3).astype(np.float32)
    return x, w_q, scale


@pytest.mark.parametrize("lead,v,d,block_v", [
    ((1,), 512, 128, 256), ((4,), 1024, 256, 256),   # test_pallas_int8's
    ((2, 3), 512, 128, 128),                          # leading dims
    ((3,), 1000, 128, 1024)])   # ragged V: the JAX block search halves to 8
def test_logits_int8_plain_matches_pallas(lead, v, d, block_v):
    x, w_q, scale = _int8_inputs(20, (*lead, d), v, d, v)
    ref = np.asarray(jax_int8.logits_int8(
        jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale),
        block_v=block_v, interpret=True))
    got = int8_matmul.logits_int8(*map(torch.from_numpy, (x, w_q, scale)))
    assert got.shape == (*lead, v) and got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= 1e-3
    np.testing.assert_array_equal(got.numpy().argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("lead,d,n,block_n", [
    ((1,), 128, 512, 128), ((8,), 256, 384, 128),    # test_pallas_int8's
    ((2, 3), 128, 512, 1024),                         # leading dims
    ((5,), 200, 1000, 1024)])   # ragged N: the JAX block search halves to 8
def test_matmul_int8_plain_matches_pallas(lead, d, n, block_n):
    x, w_q, scale = _int8_inputs(21, (*lead, d), d, n, n)
    ref = np.asarray(jax_int8.matmul_int8(
        jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale),
        block_n=block_n, interpret=True))
    got = int8_matmul.matmul_int8(*map(torch.from_numpy, (x, w_q, scale)))
    assert got.shape == (*lead, n) and got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= 1e-3
    np.testing.assert_array_equal(got.numpy().argmax(-1), ref.argmax(-1))


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


def _q4(r, n_in, n_out, tile=None):
    """Fan-in scaled weights through the JAX package's int4 packing (per
    tile of `tile` rows when given)."""
    w = jnp.asarray(r.randn(n_in, n_out).astype(np.float32) / np.sqrt(n_in))
    q = (jax_fused_mlp.quantize_int4_tiled(w, tile) if tile
         else jax_int4.quantize_int4(w))
    return np.array(q[0]), np.array(q[1])


# (M, H, I, tile): one tile, and 4 / 8 tiles, where a wrong tile mapping of
# the second projection shows
@pytest.mark.parametrize("m,h,i,block", [(1, 256, 1024, 256), (3, 128, 512, 512),
                                         (17, 64, 1024, 128)])
def test_gated_mlp_int4_plain_matches_pallas(m, h, i, block):
    r = np.random.RandomState(15)
    (wg, sg), (wu, su), (wd, sd) = _q4(r, h, i), _q4(r, h, i), _q4(r, i, h, block)
    x = r.randn(m, h).astype(np.float32)
    args = (x, wg, sg, wu, su, wd, sd)
    ref = jax_fused_mlp.gated_mlp_int4(*map(jnp.asarray, args), block_i=block,
                                       interpret=True)
    got = fused_mlp.gated_mlp_int4(*map(torch.from_numpy, args), tile=block)
    assert _rel(got.numpy(), ref) <= 1e-3


@pytest.mark.parametrize("m,d,i,block,act", [(1, 128, 1024, 256, "swish"),
                                             (3, 64, 512, 512, "relu"),
                                             (17, 32, 256, 64, "swish"),
                                             (3, 64, 512, 128, "relu")])
def test_ffn_int4_plain_matches_pallas(m, d, i, block, act):
    r = np.random.RandomState(16)
    (w1, s1), (w2, s2) = _q4(r, d, i), _q4(r, i, d, block)
    b1 = (0.1 * r.randn(i)).astype(np.float32)
    b2 = (0.1 * r.randn(d)).astype(np.float32)
    x = r.randn(2, m, d).astype(np.float32)           # leading batch dims
    args = (x, w1, s1, b1, w2, s2, b2)
    ref = jax_fused_mlp.ffn_int4(*map(jnp.asarray, args), activation=act,
                                 block_i=block, interpret=True)
    got = fused_mlp.ffn_int4(*map(torch.from_numpy, args), activation=act,
                             tile=block)
    assert got.shape == (2, m, d)
    assert _rel(got.numpy(), ref) <= 1e-3


@pytest.mark.parametrize("i,h,tile,group", [(1024, 128, 256, None),
                                            (8192, 16, 512, None),
                                            (192, 40, 64, 16), (96, 8, 96, None)])
def test_int4_tiled_packing_is_byte_identical_to_jax(i, h, tile, group):
    r = np.random.RandomState(17)
    w = r.randn(i, h).astype(np.float32)
    jp, js = jax_fused_mlp.quantize_int4_tiled(jnp.asarray(w), tile, group)
    pp, ps = fused_mlp.quantize_int4_tiled(torch.from_numpy(w), tile, group)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        fused_mlp.dequantize_int4_tiled(pp, ps, tile).numpy(),
        np.asarray(jax_fused_mlp.dequantize_int4_tiled(jp, js, tile)))


@pytest.mark.parametrize("fn", ["gated", "ffn"])
def test_fused_int4_dispatch_over_256_rows_matches_jax(fn):
    """Past 256 rows both sides take the unfused math on the same weights:
    the int4 first projection dequantized, the per-tile second projection
    dequantized tile by tile."""
    from taste_spokenlm_tpu.ops import quantized as jq
    from taste_spokenlm_tpu_torch.ops import quantized as pq
    r = np.random.RandomState(18)
    h, i = 64, 1024                       # two tiles of 512
    x = r.randn(300, h).astype(np.float32)
    first = [_q4(r, h, i) for _ in range(2)]
    wd, sd = _q4(r, i, h, 512)
    b1 = (0.1 * r.randn(i)).astype(np.float32)
    b2 = (0.1 * r.randn(h)).astype(np.float32)
    j, p = (lambda *a: tuple(map(jnp.asarray, a)),
            lambda *a: tuple(map(torch.from_numpy, a)))
    if fn == "gated":
        ref = jq.fused_gated_mlp_apply(jnp.asarray(x), j(*first[0]),
                                       j(*first[1]), j(wd, sd), "int4",
                                       jnp.float32)
        got = pq.fused_gated_mlp_apply(torch.from_numpy(x), p(*first[0]),
                                       p(*first[1]), p(wd, sd), "int4",
                                       torch.float32)
    else:
        ref = jq.fused_ffn_apply(jnp.asarray(x), j(*first[0], b1),
                                 j(wd, sd, b2), "int4", jnp.float32)
        got = pq.fused_ffn_apply(torch.from_numpy(x), p(*first[0], b1),
                                 p(wd, sd, b2), "int4", torch.float32)
    assert _rel(got.numpy(), ref) <= 1e-4


def _relpos_inputs(b, t, h, seed=0):
    r = np.random.RandomState(seed)
    mk = lambda *shape: (0.3 * r.randn(*shape)).astype(np.float32)  # noqa: E731
    return (mk(b, t, h, 128), mk(b, t, h, 128), mk(b, t, h, 128),
            mk(b, t, h, 128), mk(2 * t - 1, h, 128))


@pytest.mark.parametrize("b,t,lens", [(2, 200, (200, 150)), (1, 130, None)])
def test_relpos_attention_plain_matches_pallas(b, t, lens):
    """The plain forward (o and its LSE) and the five gradients of the
    autograd function (the plain backward on the CPU) against the Pallas
    kernel in interpret mode with its custom VJP, as
    tests/test_relpos_flash.py runs it; 1e-4 of each tensor's largest
    value (f32)."""
    xs = _relpos_inputs(b, t, 2)
    w = np.random.RandomState(7).randn(b, t, 2, 128).astype(np.float32)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    tl = None if lens is None else torch.tensor(lens)
    jax_relpos._INTERPRET[0] = True
    try:
        o_ref = jax_relpos.relpos_causal_attention(*map(jnp.asarray, xs), jl)
        g_ref = jax.grad(lambda *a: jnp.sum(
            jax_relpos.relpos_causal_attention(*a, jl) * w),
            argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, xs))
        lse_ref = jax_relpos._fwd_call(
            *map(jnp.asarray, xs),
            jnp.full((b,), t, jnp.int32) if jl is None else jl)[1][-1]
    finally:
        jax_relpos._INTERPRET[0] = False
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    o = relpos_attention.relpos_causal_attention(*ts, tl)
    (o * torch.from_numpy(w)).sum().backward()
    rel = lambda a, ref: (np.max(np.abs(a - ref))  # noqa: E731
                          / max(np.max(np.abs(ref)), 1e-12))
    assert rel(o.detach().numpy(), np.asarray(o_ref)) <= 1e-4
    _, lse = relpos_attention.relpos_causal_attention_plain(
        *(x.detach() for x in ts), tl)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[:, 0, :t],
                               atol=1e-4, rtol=0)
    for name, x, g in zip(("q_u", "q_v", "k", "v", "p"), ts, g_ref):
        assert rel(x.grad.numpy(), np.asarray(g)) <= 1e-4, name
    assert launch_counts()["relpos_causal_attention"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relpos_attention_bwd_plain_matches_autograd(dtype):
    """The plain backward (recomputed from the LSE, the kernel's cast
    points) against torch's autograd of the plain forward, at T = 600 (two
    of the Pallas kernel's 512-wide key chunks), ragged lengths; 1e-4 of
    each gradient's largest value in f32, 2e-2 in bf16 (prob and g are
    rounded to bf16 before the products)."""
    b, t, h = 2, 600, 1
    xs = [torch.from_numpy(x).to(dtype).requires_grad_()
          for x in _relpos_inputs(b, t, h, seed=3)]
    lens = torch.tensor([600, 333])
    o, lse = relpos_attention.relpos_causal_attention_plain(*xs, lens)
    do = torch.from_numpy(np.random.RandomState(4).randn(b, t, h, 128)
                          .astype(np.float32)).to(dtype)
    auto = torch.autograd.grad(o, xs, do)
    got = relpos_attention.relpos_causal_attention_bwd_plain(
        *(x.detach() for x in xs), lens, o.detach(), lse.detach(), do)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, a, g in zip(("q_u", "q_v", "k", "v", "p"), auto, got):
        err = (a.float() - g.float()).abs().max() / a.float().abs().max()
        assert err.item() <= tol, name
    assert bool((got[4][t:] == 0).all())


def _relpos_dqv_dp_by_tiles(q_u, q_v, k, v, p, lengths, lse, do, o):
    """dq_v and dp computed the way the bf16 backward kernel
    (csrc/relpos_attention.cu, dq_kernel_mma / dp_kernel_mma / dp_sum_kernel)
    decomposes them, in f32: 64 x 64 (query, key) tile pairs, each with the
    128-row table window from (T-1) - q0 - 63 + k0; each 16-row group wi of
    a query tile reads the 80 window rows from 48 - 16 wi, its bd term
    X[rl][15 - rl + c] of X = q_v . window^T and dq_v += gw . window with
    gw[rl][15 - rl + c] = g[rl][c]; dp per (batch row, tile diagonal dd)
    from gW[r][63 - r + c] = g[r][c] against q_v, then each table row
    (T-1) - delta summed over the batch and the diagonals whose window row
    63 + 64 dd - delta lies in [0, 126], in that order."""
    b, t, h, dk = q_u.shape
    nt, scale = -(-t // 64), dk ** -0.5
    pad = lambda x: torch.cat([x, x.new_zeros((nt * 64 - t,) + x.shape[1:])])  # noqa: E731
    dq_v = torch.zeros(b, nt * 64, h, dk)
    part = torch.zeros(b, nt, 128, h, dk)
    delta = (do * o).sum(-1)                                   # [B, T, H]
    for bi in range(b):
        qu, qv, kk, vv, dd_o = (pad(x[bi]) for x in (q_u, q_v, k, v, do))
        dl = pad(delta[bi])
        ls = pad(lse.reshape(b, h, t)[bi].t())                 # [T, H]
        n = int(lengths[bi])
        for hi in range(h):
            for qt in range(nt):
                for kt in range(min(qt, (n - 1) // 64) + 1 if n > 0 else 0):
                    q0, k0 = 64 * qt, 64 * kt
                    rows = torch.arange(t - 1 - q0 - 63 + k0,
                                        t - 1 - q0 - 63 + k0 + 128)
                    ok = (rows >= 0) & (rows < t)
                    win = torch.zeros(128, dk)
                    win[ok] = p[rows[ok], hi]
                    qs, ks = slice(q0, q0 + 64), slice(k0, k0 + 64)
                    ac = qu[qs, hi] @ kk[ks, hi].t()
                    bd = torch.zeros(64, 64)
                    for wi in range(4):
                        wb = 48 - 16 * wi
                        x = qv[q0 + 16 * wi:q0 + 16 * wi + 16, hi] \
                            @ win[wb:wb + 80].t()              # [16, 80]
                        for rl in range(16):
                            bd[16 * wi + rl] = x[rl, 15 - rl:79 - rl]
                    i = torch.arange(q0, q0 + 64)[:, None]
                    j = torch.arange(k0, k0 + 64)[None, :]
                    mask = (j <= i) & (j < n) & (i < t)
                    prob = torch.where(
                        mask, torch.exp((ac + bd) * scale - ls[qs, hi, None]),
                        torch.zeros(()))
                    dpv = dd_o[qs, hi] @ vv[ks, hi].t()
                    g = prob * (dpv - dl[qs, hi, None]) * scale
                    for wi in range(4):
                        wb = 48 - 16 * wi
                        gw = torch.zeros(16, 80)
                        for rl in range(16):
                            gw[rl, 15 - rl:79 - rl] = g[16 * wi + rl]
                        dq_v[bi, q0 + 16 * wi:q0 + 16 * wi + 16, hi] += \
                            gw @ win[wb:wb + 80]
                    gW = torch.zeros(64, 128)
                    for r in range(64):
                        gW[r, 63 - r:127 - r] = g[r]
                    part[bi, qt - kt, :, hi] += gW.t() @ qv[qs, hi]
    dp = torch.zeros(2 * t - 1, h, dk)
    for r in range(t):
        dl_ = t - 1 - r
        for bi in range(b):
            for dd in range(dl_ // 64, min(nt - 1, (dl_ + 63) // 64) + 1):
                dp[r] += part[bi, dd, 63 + 64 * dd - dl_]
    return dq_v[:, :t], dp


@pytest.mark.parametrize("t", [200, 257, 320])
def test_relpos_bwd_tile_decomposition_matches_plain(t):
    """The design of the bf16 backward's dq_v and dp (table windows per
    tile pair, the skew as one offset read, per-diagonal partials summed in
    a fixed order), written in f32 torch, against
    relpos_causal_attention_bwd_plain: T one row past a tile (257), a
    ragged last tile (200, 320), B = 2, H = 2, ragged lengths; 1e-5 of each
    gradient's largest value (the same f32 arithmetic in another order).
    It checks the design, not the kernel: it runs a test-local copy of the
    kernels' index arithmetic, and the kernel itself is held against the
    plain backward on the card (test_torch_cuda.py,
    test_relpos_attention_matches_plain, T = 257 among its cases)."""
    b, h = 2, 2
    xs = [torch.from_numpy(x) for x in _relpos_inputs(b, t, h, seed=t)]
    lens = torch.tensor([t, t // 2 + 3])
    o, lse = relpos_attention.relpos_causal_attention_plain(*xs, lens)
    do = torch.from_numpy(np.random.RandomState(t + 1).randn(b, t, h, 128)
                          .astype(np.float32))
    ref = relpos_attention.relpos_causal_attention_bwd_plain(
        *xs, lens, o, lse, do)
    dq_v, dp = _relpos_dqv_dp_by_tiles(*xs, lens, lse, do, o)
    for name, got, want in (("dq_v", dq_v, ref[1]), ("dp", dp, ref[4])):
        err = (got - want).abs().max() / want.abs().max()
        assert err.item() <= 1e-5, (name, err.item())
    assert bool((dp[t:] == 0).all())


def _relpos_fwd_by_tiles(q_u, q_v, k, v, p, lengths):
    """o and the LSE computed the way the bf16 forward kernel
    (csrc/relpos_attention.cu, fwd_kernel_mma with score_tile) decomposes
    them, in f32: 64-row query tiles, each 16-row group wi reading the 80
    rows from 48 - 16 wi of its key tile's 128-row table window (from (T-1)
    - q0 - 63 + k0), its bd term X[rl][15 - rl + c] of X = q_v .
    window^T; two groups of warps taking the key tiles j <= i in turn
    (group kt % 2), each with its own online softmax (running max m, alpha =
    exp(m_old - m_new) rescaling l and the o sum), e rounded to the value
    dtype before e . v, l summed before the rounding; the groups' (m, l, o)
    folded in group order at the end; o = acc / max(l, 1e-30) and lse = m +
    log(max(l, 1e-30))."""
    b, t, h, dk = q_u.shape
    nt, scale = -(-t // 64), dk ** -0.5
    pad = lambda x: torch.cat([x, x.new_zeros((nt * 64 - t,) + x.shape[1:])])  # noqa: E731
    o = torch.zeros(b, nt * 64, h, dk)
    lse = torch.zeros(b, h, nt * 64)
    for bi in range(b):
        qu, qv, kk, vv = (pad(x[bi]) for x in (q_u, q_v, k, v))
        n = int(lengths[bi])
        for hi in range(h):
            for qt in range(nt):
                q0 = 64 * qt
                groups = [[torch.full((64,), -1e30), torch.zeros(64),
                           torch.zeros(64, dk)] for _ in range(2)]
                for kt in range(min(qt, (n - 1) // 64) + 1 if n > 0 else 0):
                    m, l, acc = groups[kt % 2]
                    k0 = 64 * kt
                    rows = torch.arange(t - 1 - q0 - 63 + k0,
                                        t - 1 - q0 - 63 + k0 + 128)
                    ok = (rows >= 0) & (rows < t)
                    win = torch.zeros(128, dk)
                    win[ok] = p[rows[ok], hi]
                    qs, ks = slice(q0, q0 + 64), slice(k0, k0 + 64)
                    s = qu[qs, hi] @ kk[ks, hi].t()
                    for wi in range(4):
                        wb = 48 - 16 * wi
                        x = qv[q0 + 16 * wi:q0 + 16 * wi + 16, hi] \
                            @ win[wb:wb + 80].t()              # [16, 80]
                        for rl in range(16):
                            s[16 * wi + rl] += x[rl, 15 - rl:79 - rl]
                    i = torch.arange(q0, q0 + 64)[:, None]
                    j = torch.arange(k0, k0 + 64)[None, :]
                    mask = (j <= i) & (j < n)
                    s = torch.where(mask, s * scale, torch.tensor(-1e30))
                    m_new = torch.maximum(m, s.amax(1))
                    alpha = torch.exp(m - m_new)
                    e = torch.where(mask, torch.exp(s - m_new[:, None]),
                                    torch.zeros(()))
                    l = l * alpha + e.sum(1)
                    acc = acc * alpha[:, None] \
                        + e.to(v.dtype).float() @ vv[ks, hi].float()
                    groups[kt % 2] = [m_new, l, acc]
                (m, l, acc), (m1, l1, acc1) = groups
                m_new = torch.maximum(m, m1)
                a0, a1 = torch.exp(m - m_new), torch.exp(m1 - m_new)
                l = l * a0 + l1 * a1
                acc = acc * a0[:, None] + acc1 * a1[:, None]
                m = m_new
                lc = torch.clamp(l, min=1e-30)
                o[bi, q0:q0 + 64, hi] = acc / lc[:, None]
                lse[bi, hi, q0:q0 + 64] = m + torch.log(lc)
    return o[:, :t], lse[..., :t].reshape(b * h, t)


@pytest.mark.parametrize("t", [200, 257, 320])
def test_relpos_fwd_tile_decomposition_matches_plain(t):
    """The design of the bf16 forward (64-row query tiles, each warp's
    80-row table window and one offset read for the bd term, two groups'
    online softmaxes across alternate key tiles and their fold, e cast
    before its product with v), written
    in f32 torch, against relpos_causal_attention_plain: T one row past a
    tile (257), a ragged last tile (200, 320), B = 2, H = 2, ragged lengths;
    o within 1e-5 of its largest value and the LSE within 1e-5 (the same
    f32 arithmetic in another order; in f32 the cast of e is exact).  It
    checks the design, not the kernel: it runs a test-local copy of the
    kernel's index arithmetic, and the kernel itself is held against the
    plain forward on the card (test_torch_cuda.py,
    test_relpos_attention_matches_plain)."""
    b, h = 2, 2
    xs = [torch.from_numpy(x) for x in _relpos_inputs(b, t, h, seed=t + 5)]
    lens = torch.tensor([t, t // 2 + 3])
    o_ref, lse_ref = relpos_attention.relpos_causal_attention_plain(*xs,
                                                                     lens)
    o, lse = _relpos_fwd_by_tiles(*xs, lens)
    err = (o - o_ref).abs().max() / o_ref.abs().max()
    assert err.item() <= 1e-5, err.item()
    assert (lse - lse_ref).abs().max().item() <= 1e-5
