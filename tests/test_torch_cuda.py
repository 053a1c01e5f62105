"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and nvcc; each skips with a reason
elsewhere.  Run on the card with:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import pytest
import torch

from taste_spokenlm_tpu_torch.kernels import (_build, conv1d, flash_attention,
                                              fused_dit, fused_mlp,
                                              int4_matmul, int8_matmul,
                                              relpos_attention)
from taste_spokenlm_tpu_torch.quant import quantize_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(g, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=g) * scale).to(dtype)


@pytest.mark.parametrize("t,h,d,causal,dtype", [
    (1500, 4, 64, False, torch.float32),
    (300, 2, 64, True, torch.float32),
    (200, 2, 32, False, torch.float32),
    (257, 2, 128, False, torch.bfloat16),
])
def test_flash_attention_matches_plain(dev, t, h, d, causal, dtype):
    g = torch.Generator().manual_seed(0)
    q, k, v = (_rand(g, 1, t, h, d, dtype=dtype).to(dev) for _ in range(3))
    out = flash_attention.flash_attention(q, k, v, causal=causal)
    ref = flash_attention.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= (1e-4 if dtype == torch.float32 else 2e-2), err


@pytest.mark.parametrize("causal,dtype", [(False, torch.float32),
                                          (True, torch.bfloat16)])
def test_flash_attention_key_lengths_match_plain(dev, causal, dtype):
    g = torch.Generator().manual_seed(3)
    q, k, v = (_rand(g, 2, 300, 2, 64, dtype=dtype).to(dev) for _ in range(3))
    lens = torch.tensor([300, 173], device=dev)
    out = flash_attention.flash_attention(q, k, v, causal=causal,
                                          kv_lengths=lens)
    ref = flash_attention.flash_attention_plain(q, k, v, causal=causal,
                                                kv_lengths=lens)
    unmasked = flash_attention.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert err <= tol, err
    # the lengths reach the kernel: without them the output moves
    assert (out.float() - unmasked.float()).abs().max().item() > 10 * tol


def test_flash_attention_bf16_at_the_training_shape(dev):
    """The frozen whisper encoder of the stage-1 step: B = 8, T = 1500, 20
    heads of 64, bf16 on the tensor cores; T = 23 x 64 + 28 ends in a
    ragged key tile, whose values, scaled up, must reach the output."""
    g = torch.Generator().manual_seed(4)
    q, k, v = (_rand(g, 8, 1500, 20, 64, dtype=torch.bfloat16).to(dev)
               for _ in range(3))
    out = flash_attention.flash_attention(q, k, v)
    ref = flash_attention.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert _rel(out.float(), ref.float()) <= 2e-2
    v_tail = v.clone()
    v_tail[:, -28:] *= 100
    moved = flash_attention.flash_attention(q, k, v_tail)
    assert _rel(moved.float(), ref.float()) > 5 * 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t", [300, 1000, 1500])
def test_flash_attention_ragged_matches_plain(dev, t, d, dtype):
    """T no multiple of the 64-key tile (nor of the query tile), every head
    dim, plain and causal, with and without per-batch key lengths."""
    g = torch.Generator().manual_seed(t + d)
    q, k, v = (_rand(g, 2, t, 2, d, dtype=dtype).to(dev) for _ in range(3))
    lens = torch.tensor([t, (2 * t) // 3 + 1], device=dev)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for causal in (False, True):
        for kv_lengths in (None, lens):
            out = flash_attention.flash_attention(
                q, k, v, causal=causal, kv_lengths=kv_lengths)
            ref = flash_attention.flash_attention_plain(
                q, k, v, causal=causal, kv_lengths=kv_lengths)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if dtype == torch.bfloat16:
                err /= ref.float().abs().max().item()
            assert err <= tol, (causal, kv_lengths is not None, err)


@pytest.mark.parametrize("t,lens", [(904, (904, 700)), (452, (452, 452)),
                                    (130, (100, 130)), (904, (904, 613)),
                                    (452, (452, 17)), (130, (130, 1)),
                                    # the streaming windows' U-Net levels
                                    (32, (27, 27)), (16, (14, 14)),
                                    (134, (113, 129)), (67, (57, 65)),
                                    (816, (811, 811)), (408, (406, 406))])
def test_fused_dit_matches_plain(dev, t, lens):
    """Within 2e-2 of the plain version on the valid rows, and the same
    bits when run twice (a fixed order in every sum), at the flow's two T,
    the streaming windows' (down to 16, below one 64-row tile) and a short
    one, with ragged lengths down to one key."""
    g = torch.Generator().manual_seed(1)
    c, heads, hd = 256, 8, 64
    inner = heads * hd

    def p(*shape, scale=0.05):
        return _rand(g, *shape, scale=scale, dtype=torch.bfloat16).to(dev)

    params = {
        "norm1": {"scale": 1.0 + p(c), "bias": p(c)},
        "attn1": {"to_q": {"kernel": p(c, inner)}, "to_k": {"kernel": p(c, inner)},
                  "to_v": {"kernel": p(c, inner)},
                  "to_out": {"kernel": p(inner, c), "bias": p(c)}},
        "norm3": {"scale": 1.0 + p(c), "bias": p(c)},
        "ff_in": {"kernel": p(c, 4 * c), "bias": p(4 * c)},
        "ff_out": {"kernel": p(4 * c, c), "bias": p(c)},
    }
    x = p(2, t, c, scale=0.5)
    lengths = torch.tensor(lens, device=dev)
    out = fused_dit.fused_dit_block(x, lengths, params, heads=heads, head_dim=hd)
    again = fused_dit.fused_dit_block(x, lengths, params, heads=heads,
                                      head_dim=hd)
    ref = fused_dit.fused_dit_block_plain(x, lengths, params, heads=heads,
                                          head_dim=hd)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    for bi, ln in enumerate(lens):
        d = (out[bi, :ln].float() - ref[bi, :ln].float()).abs().max().item()
        scale = ref[bi, :ln].float().abs().max().item()
        assert d <= 2e-2 * scale, (bi, d, scale)


@pytest.mark.parametrize("t,c,k,dil", [(7232, 256, 3, 1), (4100, 128, 11, 5),
                                       (1000, 128, 7, 3),
                                       # the streaming windows' stages
                                       (8577, 128, 11, 5), (6528, 256, 7, 3),
                                       (52225, 128, 3, 1)])
def test_conv1d_matches_plain(dev, t, c, k, dil):
    g = torch.Generator().manual_seed(2)
    x = _rand(g, 1, t, c, dtype=torch.bfloat16).to(dev)
    w = _rand(g, k, c, c, scale=0.05, dtype=torch.bfloat16).to(dev)
    b = _rand(g, c, scale=0.1, dtype=torch.bfloat16).to(dev)
    out = conv1d.conv1d_same(x, w, b, dilation=dil)
    ref = conv1d.conv1d_same_plain(x, w, b, dilation=dil)
    torch.cuda.synchronize()
    d = (out.float() - ref.float()).abs().max().item()
    assert d <= 2e-2 * ref.float().abs().max().item(), d


# the HiFT path's two extremes: the longest taps at 128 channels over a T
# that no tile divides, and the 256-channel stage
@pytest.mark.parametrize("t,c,k,dil", [(57857, 128, 11, 5), (7232, 256, 7, 1)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_conv1d_path_shapes_repeat_bit_for_bit(dev, t, c, k, dil, with_bias):
    """The kernel with its bias in the epilogue (or none) within 2e-2 of
    max|plain|, the same bits twice, and the last T tile's x rows reaching
    the output."""
    g = torch.Generator().manual_seed(20)
    x = _rand(g, 1, t, c, dtype=torch.bfloat16).to(dev)
    w = _rand(g, k, c, c, scale=0.02, dtype=torch.bfloat16).to(dev)
    b = _rand(g, c, scale=0.3).to(dev) if with_bias else None
    out = conv1d.conv1d_same(x, w, b, dilation=dil)
    ref = conv1d.conv1d_same_plain(x, w, b, dilation=dil)
    torch.cuda.synchronize()
    assert out.shape == (1, t, c) and out.dtype == torch.bfloat16
    assert _rel(out.float(), ref.float()) <= 2e-2
    assert torch.equal(conv1d.conv1d_same(x, w, b, dilation=dil), out)
    tail = x.clone()
    tail[:, -1] = 0
    moved = conv1d.conv1d_same(tail, w, b, dilation=dil)
    assert not torch.equal(moved[:, -1], out[:, -1])
    assert torch.equal(moved[:, : t - 64], out[:, : t - 64])


# the contract beyond the HiFT shapes: a batch, 32-channel chunks (Cin =
# 96), 64-channel output tiles (Cout = 192, 64), and K = 1 (no halo, the
# shorter weight ring)
@pytest.mark.parametrize("b,t,cin,cout,k,dil", [(2, 700, 96, 192, 3, 1),
                                               (1, 1000, 128, 128, 1, 1),
                                               (3, 300, 256, 64, 5, 2)])
def test_conv1d_other_tiles_match_plain(dev, b, t, cin, cout, k, dil):
    g = torch.Generator().manual_seed(21)
    x = _rand(g, b, t, cin, dtype=torch.bfloat16).to(dev)
    w = _rand(g, k, cin, cout, scale=0.05, dtype=torch.bfloat16).to(dev)
    bias = _rand(g, cout, scale=0.3).to(dev)
    out = conv1d.conv1d_same(x, w, bias, dilation=dil)
    ref = conv1d.conv1d_same_plain(x, w, bias, dilation=dil)
    torch.cuda.synchronize()
    assert out.shape == (b, t, cout)
    assert _rel(out.float(), ref.float()) <= 2e-2
    assert torch.equal(conv1d.conv1d_same(x, w, bias, dilation=dil), out)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 64, 96, dtype=torch.bfloat16, device=dev)
    w = torch.zeros(3, 96, 96, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        conv1d.conv1d_same(x, w)
    with pytest.raises(TypeError):
        conv1d.conv1d_same(x.float(), w.float())
    q = torch.zeros(1, 64, 2, 48, device=dev)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, q, q)


def _q8(g, n_in, n_out, dev):
    """Fan-in scaled random weights through the port's int8 quantizer."""
    q = quantize_kernel(torch.randn(n_in, n_out, generator=g) * n_in ** -0.5)
    return q["base_q"].to(dev), q["base_scale"].to(dev)


def _rel(out, ref):
    return ((out - ref).abs().max() / ref.abs().max()).item()


# the path's shapes (the S3-stack and Llama decode steps, the Llama
# prefill), row counts on either side of the 16-row tiles, and the serving
# engine's batched decode: a step of 2, 4, 8 or 16 rows and the prefill of
# nb x 42 rows (bench.py's 40-token prompt) up to the fused limit
GATED_SHAPES = [(1, 1024, 2048), (1, 2048, 8192), (42, 2048, 8192),
                (9, 2048, 8192), (17, 2048, 8192), (40, 2048, 8192),
                (256, 2048, 8192), (2, 2048, 8192), (4, 2048, 8192),
                (8, 2048, 8192), (16, 2048, 8192), (84, 2048, 8192),
                (168, 2048, 8192)]


@pytest.mark.parametrize("m,h,i", GATED_SHAPES)
def test_gated_mlp_int8_matches_plain(dev, m, h, i):
    g = torch.Generator().manual_seed(4)
    (wg, sg), (wu, su), (wd, sd) = (_q8(g, h, i, dev), _q8(g, h, i, dev),
                                    _q8(g, i, h, dev))
    x = torch.randn(m, h, generator=g).to(dev, torch.bfloat16)
    out = fused_mlp.gated_mlp_int8(x, wg, sg, wu, su, wd, sd)
    ref = fused_mlp.gated_mlp_int8_plain(x, wg, sg, wu, su, wd, sd)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= 2e-2
    for _ in range(2):          # no float atomics: the same bits every call
        assert torch.equal(fused_mlp.gated_mlp_int8(x, wg, sg, wu, su, wd, sd),
                           out)
    # the gate reaches the output: a zeroed gate moves it past the tolerance
    no_gate = fused_mlp.gated_mlp_int8(x, torch.zeros_like(wg), sg, wu, su,
                                       wd, sd)
    assert _rel(no_gate, ref) > 5 * 2e-2


def _graph_replays(fn, x, args):
    """fn(x, *args) captured in a CUDA graph gives the eager call's bits on
    every replay (its arrival counters persist between calls) and follows
    its input."""
    first = fn(x, *args)
    static_x = x.clone()
    side = torch.cuda.Stream(x.device)
    side.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(side):
        fn(static_x, *args)
    torch.cuda.current_stream(x.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = fn(static_x, *args)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static_out, first)
    static_x.copy_(2 * x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static_out, fn(2 * x, *args))


# one row (the SIMT kernel) and the prefill's 42 (the tensor-core kernel,
# its counters per row tile and rank)
@pytest.mark.parametrize("m", [1, 42])
def test_gated_mlp_int8_replays_in_a_graph(dev, m):
    g = torch.Generator().manual_seed(21)
    h, i = 2048, 8192
    (wg, sg), (wu, su), (wd, sd) = (_q8(g, h, i, dev), _q8(g, h, i, dev),
                                    _q8(g, i, h, dev))
    x = torch.randn(m, h, generator=g).to(dev, torch.bfloat16)
    _graph_replays(fused_mlp.gated_mlp_int8, x, (wg, sg, wu, su, wd, sd))


def _ffn8(g, d, i, dev):
    """The conformer FFN's int8 weights, scales and biases (w1, s1, b1, w2,
    s2, b2), fan-in scaled and seeded."""
    (w1, s1), (w2, s2) = _q8(g, d, i, dev), _q8(g, i, d, dev)
    b1 = (0.1 * torch.randn(i, generator=g)).to(dev)
    b2 = (0.1 * torch.randn(d, generator=g)).to(dev)
    return w1, s1, b1, w2, s2, b2


# the S3 stack's decode step (M = 1: the SIMT kernel) and its 131-row
# prefill, rows on either side of the 16-row tiles, a tiny width
@pytest.mark.parametrize("m,d,i", [(1, 1024, 2048), (40, 1024, 2048),
                                   (131, 1024, 2048), (256, 1024, 2048),
                                   (3, 32, 64)])
def test_ffn_int8_matches_plain(dev, m, d, i):
    g = torch.Generator().manual_seed(5)
    args = _ffn8(g, d, i, dev)
    x = torch.randn(m, d, generator=g).to(dev, torch.bfloat16)
    out = fused_mlp.ffn_int8(x, *args)
    ref = fused_mlp.ffn_int8_plain(x, *args)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= 2e-2
    for _ in range(2):          # no float atomics: the same bits every call
        assert torch.equal(fused_mlp.ffn_int8(x, *args), out)
    # the first projection reaches the output: zeroed, it moves it past
    # the tolerance
    no_w1 = fused_mlp.ffn_int8(x, torch.zeros_like(args[0]), *args[1:])
    assert _rel(no_w1, ref) > 5 * 2e-2


@pytest.mark.parametrize("m", [1, 131])
def test_ffn_int8_replays_in_a_graph(dev, m):
    g = torch.Generator().manual_seed(23)
    args = _ffn8(g, 1024, 2048, dev)
    x = torch.randn(m, 1024, generator=g).to(dev, torch.bfloat16)
    _graph_replays(fused_mlp.ffn_int8, x, args)


# the tied head of the serving engine's batched decode at 2-16 rows (16:
# past SPLIT_MAX_ROWS, unsplit)
@pytest.mark.parametrize("m,d,n", [(1, 2048, 128256), (40, 2048, 4097),
                                   (256, 1024, 4097), (3, 512, 1000),
                                   (1, 1024, 1024), (131, 1024, 3072),
                                   (42, 2048, 3072), (200, 8192, 2048),
                                   (2, 2048, 128256), (4, 2048, 128256),
                                   (8, 2048, 128256), (16, 2048, 128256)])
def test_matmul_int4_matches_plain(dev, m, d, n):
    g = torch.Generator().manual_seed(6)
    wp, scale = int4_matmul.quantize_int4(
        torch.randn(d, n, generator=g) * d ** -0.5)
    wp, scale = wp.to(dev), scale.to(dev)
    x = torch.randn(m, d, generator=g).to(dev, torch.bfloat16)
    out = int4_matmul.matmul_int4(x, wp, scale)
    ref = int4_matmul.matmul_int4_plain(x, wp, scale)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= 1e-3
    # both nibble planes reach the output: swapping them moves it
    half = wp.shape[0]
    swapped = ((wp >> 4) | (wp << 4)).contiguous()
    moved = int4_matmul.matmul_int4(x, swapped, scale)
    assert _rel(moved, ref) > 5 * 1e-3
    lead = int4_matmul.matmul_int4(x.reshape(1, m, d), wp, scale)
    assert torch.equal(lead[0], out) and half * 2 == d


# every M = 1 shape of the int4 paths: the Llama-1B and S3 projections,
# fused qkv and gate-up, the Llama down projection, the tied head; and a
# ragged N
@pytest.mark.parametrize("d,n", [(1024, 1024), (1024, 3072), (1024, 4096),
                                 (2048, 1024), (2048, 2048), (2048, 3072),
                                 (8192, 2048), (2048, 16384), (2048, 128256),
                                 (2048, 4097), (1024, 4097)])
def test_matmul_int4_decode_shapes_match_plain(dev, d, n):
    """M = 1 through the split contraction: within 1e-3 of the plain
    version, the same bits twice, and the last row of the last slice (in
    both nibble planes) reaching the output."""
    g = torch.Generator().manual_seed(16)
    wp, scale = int4_matmul.quantize_int4(
        torch.randn(d, n, generator=g) * d ** -0.5)
    wp, scale = wp.to(dev), scale.to(dev)
    x = torch.randn(1, d, generator=g).to(dev, torch.bfloat16)
    out = int4_matmul.matmul_int4(x, wp, scale)
    ref = int4_matmul.matmul_int4_plain(x, wp, scale)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= 1e-3
    assert torch.equal(int4_matmul.matmul_int4(x, wp, scale), out)
    last = x.clone()
    last[:, d // 2 - 1] = 0      # the last packed row's low nibbles
    last[:, d - 1] = 0           # and its high nibbles
    assert not torch.equal(int4_matmul.matmul_int4(last, wp, scale), out)


@pytest.mark.parametrize("m,d,n", [(1, 1024, 3072), (1, 8192, 2048),
                                   (2, 2048, 2048), (5, 1024, 1000),
                                   (8, 2048, 4096)])
def test_matmul_int4_repeats_bit_for_bit_and_in_a_graph(dev, m, d, n):
    """The split kernel's fixed-order sum over a cluster: two calls, and the
    replays of a CUDA graph that captured it, give the same bits as an
    eager call."""
    g = torch.Generator().manual_seed(17)
    wp, scale = int4_matmul.quantize_int4(
        torch.randn(d, n, generator=g) * d ** -0.5)
    wp, scale = wp.to(dev), scale.to(dev)
    x = torch.randn(m, d, generator=g).to(dev, torch.bfloat16)
    first = int4_matmul.matmul_int4(x, wp, scale)
    assert torch.equal(int4_matmul.matmul_int4(x, wp, scale), first)
    assert _rel(first, int4_matmul.matmul_int4_plain(x, wp, scale)) <= 1e-3
    static_x = x.clone()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        int4_matmul.matmul_int4(static_x, wp, scale)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = int4_matmul.matmul_int4(static_x, wp, scale)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static_out, first)
    static_x.copy_(2 * x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static_out, int4_matmul.matmul_int4(2 * x, wp, scale))


def test_quantized_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 64, dtype=torch.bfloat16, device=dev)
    w = torch.zeros(64, 80, dtype=torch.int8, device=dev)
    s = torch.ones(80, device=dev)
    with pytest.raises(ValueError):        # I % 32 != 0
        fused_mlp.gated_mlp_int8(x, w, s, w, s, w.T.contiguous(),
                                 torch.ones(64, device=dev))
    wp = torch.zeros(32, 96, dtype=torch.uint8, device=dev)
    with pytest.raises(TypeError):         # float16 scales
        int4_matmul.matmul_int4(x, wp, torch.ones(2, 96, device=dev).half())
    w1 = torch.zeros(32, 48, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):        # tile 48 is not a multiple of 32
        fused_mlp.ffn_int4(x, w1, torch.ones(2, 48, device=dev),
                           torch.zeros(48, device=dev),
                           torch.zeros(24, 64, dtype=torch.uint8, device=dev),
                           torch.ones(2, 64, device=dev),
                           torch.zeros(64, device=dev))


def _q4(g, n_in, n_out, dev, tile=None, group=None):
    """Fan-in scaled random weights through the port's int4 packing (per
    tile of `tile` rows when given; `group` rows a scale, else the
    default)."""
    w = torch.randn(n_in, n_out, generator=g) * n_in ** -0.5
    q = (fused_mlp.quantize_int4_tiled(w, tile, group) if tile
         else int4_matmul.quantize_int4(w, group))
    return q[0].to(dev), q[1].to(dev)


@pytest.mark.parametrize("m,h,i,group", [
    *[(*shape, None) for shape in GATED_SHAPES],
    (3, 256, 1024, None), (5, 64, 128, None),
    (4, 64, 128, 16), (3, 64, 128, 32), (2, 32, 64, 16)])  # tiny groups
def test_gated_mlp_int4_matches_plain(dev, m, h, i, group):
    g = torch.Generator().manual_seed(7)
    tile = fused_mlp.mlp_tile(i)
    (wg, sg), (wu, su) = _q4(g, h, i, dev, group=group), _q4(g, h, i, dev,
                                                         group=group)
    wd, sd = _q4(g, i, h, dev, tile, group)
    x = torch.randn(m, h, generator=g).to(dev, torch.bfloat16)
    args = (x, wg, sg, wu, su, wd, sd)
    out = fused_mlp.gated_mlp_int4(*args)
    ref = fused_mlp.gated_mlp_int4_plain(*args)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= 2e-2
    for _ in range(2):          # no float atomics: the same bits every call
        assert torch.equal(fused_mlp.gated_mlp_int4(*args), out)
    # each half of the per-tile packing reaches the output
    swapped = ((wd >> 4) | (wd << 4)).contiguous()
    moved = fused_mlp.gated_mlp_int4(x, wg, sg, wu, su, swapped, sd)
    assert _rel(moved, ref) > 5 * 2e-2


@pytest.mark.parametrize("m", [1, 42])
def test_gated_mlp_int4_replays_in_a_graph(dev, m):
    g = torch.Generator().manual_seed(22)
    h, i = 2048, 8192
    (wg, sg), (wu, su) = _q4(g, h, i, dev), _q4(g, h, i, dev)
    wd, sd = _q4(g, i, h, dev, fused_mlp.mlp_tile(i))
    x = torch.randn(m, h, generator=g).to(dev, torch.bfloat16)
    _graph_replays(fused_mlp.gated_mlp_int4, x, (wg, sg, wu, su, wd, sd))


@pytest.mark.parametrize("kind", ["int8", "int4", "ffn_int8", "ffn_int4"])
def test_gated_geometry_matches_the_plan(dev, kind):
    """The kernel takes gated_plan's plan at the path's shapes and the tiny
    widths, its slot count (which sizes the partial sums) is the one the
    plan ranks its candidates by, and its last slot starts where the plan's
    last cluster does (int8: an I row; int4: a packed row); the FFNs' too,
    at their own shapes (the S3 stack's decode step and prefill)."""
    sms = _build.sm_count(dev)
    ffn = kind.startswith("ffn")
    shapes = ([(1, 1024, 2048), (131, 1024, 2048), (40, 1024, 2048)] if ffn
              else GATED_SHAPES)
    for m, h, i in [*shapes, (3, 256, 1024), (5, 64, 128), (2, 32, 64)]:
        tile = fused_mlp.mlp_tile(i) if kind.endswith("int4") else None
        extra = (() if tile is None else
                 (tile, int4_matmul._group(h),
                  tile // int4_matmul._group(tile)))
        plan, slots, row = fused_mlp.gated_geometry(m, h, i, sms, *extra,
                                                    ffn=ffn)
        assert plan == fused_mlp.gated_plan(m, h, i, sms, tile)
        cluster, cols, simt = plan
        # the kernel's row tiles (its arrival counters) as the plan counts
        # them
        dims = (m, h, i) if tile is None else (m, h, i, *extra)
        tiles = fused_mlp._geometry(dims, plan, ffn)[2]
        assert tiles == (1 if simt else -(-m // fused_mlp.GATED_ROWS))
        if simt:
            chunks = i // 32 if tile else i // 16
            assert (slots, row) == (simt, 16 * ((simt - 1) * chunks // simt))
        elif tile is None:
            assert slots == fused_mlp.gated_clusters(i, cols)
            assert row == (slots - 1) * cols
        else:
            assert slots == fused_mlp.gated_clusters(i, cols, tile)
            per_tile = slots // (i // tile)
            assert row == i // 2 - tile // 2 + (per_tile - 1) * cols // 2


def _ffn4(g, d, i, dev):
    """The conformer FFN's int4 weights, scales and biases (w1, s1, b1, w2,
    s2, b2), W2 packed per tile, fan-in scaled and seeded."""
    tile = fused_mlp.mlp_tile(i)
    w1, s1 = _q4(g, d, i, dev)
    w2, s2 = _q4(g, i, d, dev, tile)
    b1 = (0.1 * torch.randn(i, generator=g)).to(dev)
    b2 = (0.1 * torch.randn(d, generator=g)).to(dev)
    return w1, s1, b1, w2, s2, b2


# the S3 stack's decode step (M = 1: the SIMT kernel) and its 131-row
# prefill, rows on either side of the 16-row tiles, a relu FFN over two
# tiles of W2, a tiny width
@pytest.mark.parametrize("m,d,i,act", [(1, 1024, 2048, "swish"),
                                       (40, 1024, 2048, "swish"),
                                       (131, 1024, 2048, "swish"),
                                       (256, 1024, 2048, "swish"),
                                       (7, 256, 1024, "relu"),
                                       (2, 32, 64, "swish")])
def test_ffn_int4_matches_plain(dev, m, d, i, act):
    g = torch.Generator().manual_seed(8)
    w1, s1, b1, w2, s2, b2 = _ffn4(g, d, i, dev)
    x = torch.randn(m, d, generator=g).to(dev, torch.bfloat16)
    args = (x, w1, s1, b1, w2, s2, b2, act)
    out = fused_mlp.ffn_int4(*args)
    ref = fused_mlp.ffn_int4_plain(*args)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= 2e-2
    for _ in range(2):          # no float atomics: the same bits every call
        assert torch.equal(fused_mlp.ffn_int4(*args), out)
    # the first projection reaches the output: zeroed, it moves it past
    # the tolerance
    no_w1 = fused_mlp.ffn_int4(x, torch.zeros_like(w1), *args[2:])
    assert _rel(no_w1, ref) > 5 * 2e-2


@pytest.mark.parametrize("m", [1, 131])
def test_ffn_int4_replays_in_a_graph(dev, m):
    g = torch.Generator().manual_seed(24)
    args = _ffn4(g, 1024, 2048, dev)
    x = torch.randn(m, 1024, generator=g).to(dev, torch.bfloat16)
    _graph_replays(fused_mlp.ffn_int4, x, args)


def _relpos_inputs(g, b, t, h, dtype, dev):
    mk = lambda *shape: _rand(g, *shape, scale=0.3, dtype=dtype).to(dev)  # noqa: E731
    return (mk(b, t, h, 128), mk(b, t, h, 128), mk(b, t, h, 128),
            mk(b, t, h, 128), mk(2 * t - 1, h, 128))


@pytest.mark.parametrize("b,t,h,lens,dtype", [
    (1, 256, 3, (256,), torch.float32),
    (3, 1599, 1, (1599, 1200, 257), torch.float32),
    (3, 1599, 1, (1599, 700, 300), torch.bfloat16),
    (3, 2048, 3, (2048, 1999, 64), torch.bfloat16),
    (3, 257, 2, (257, 1, 256), torch.bfloat16),
    (3, 257, 2, (257, 1, 256), torch.float32),
    (8, 1599, 8, (1599, 1199, 700, 266, 1598, 999, 499, 299), torch.bfloat16),
])
def test_relpos_attention_matches_plain(dev, b, t, h, lens, dtype):
    """Forward (o and LSE) and the five gradients against the plain
    versions, ragged lengths and an odd B*H; the forward and the backward
    twice give the same bits (no atomics).  T = 257 leaves one row in the
    last query, key and diagonal tile, beside rows of length 1 and T - 1;
    [8, 1599, 8] is the stage-1 training shape."""
    g = torch.Generator().manual_seed(11)
    xs = _relpos_inputs(g, b, t, h, dtype, dev)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    o, lse = relpos_attention.relpos_causal_attention_fwd(*xs, lens)
    o_ref, lse_ref = relpos_attention.relpos_causal_attention_plain(*xs, lens)
    torch.cuda.synchronize()
    o2, lse2 = relpos_attention.relpos_causal_attention_fwd(*xs, lens)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    err = (o.float() - o_ref.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= tol, err
    else:
        assert err <= tol * o_ref.float().abs().max().item(), err
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    do = _rand(g, b, t, h, 128, dtype=dtype).to(dev)
    grads = relpos_attention.relpos_causal_attention_bwd(*xs, lens, o, lse, do)
    refs = relpos_attention.relpos_causal_attention_bwd_plain(
        *xs, lens, o, lse, do)
    for name, got, ref in zip(("dq_u", "dq_v", "dk", "dv", "dp"), grads, refs):
        assert _rel(got.float(), ref.float()) <= tol, name
    assert bool((grads[4][t:] == 0).all())
    again = relpos_attention.relpos_causal_attention_bwd(*xs, lens, o, lse, do)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))


def test_relpos_attention_autograd_counts(dev):
    g = torch.Generator().manual_seed(12)
    xs = [x.requires_grad_() for x in
          _relpos_inputs(g, 2, 300, 2, torch.float32, dev)]
    relpos_attention.relpos_causal_attention.launches = 0
    relpos_attention.relpos_causal_attention_bwd.launches = 0
    o = relpos_attention.relpos_causal_attention(
        *xs, torch.tensor([300, 200], device=dev))
    o.square().sum().backward()
    assert relpos_attention.relpos_causal_attention.launches == 1
    assert relpos_attention.relpos_causal_attention_bwd.launches == 1
    assert all(x.grad is not None and bool(x.grad.abs().sum() > 0) for x in xs)


def test_relpos_wrapper_rejects_what_the_kernel_does_not_take(dev):
    g = torch.Generator().manual_seed(13)
    xs = _relpos_inputs(g, 1, 256, 1, torch.float32, dev)
    with pytest.raises(ValueError):        # T < 256
        relpos_attention.relpos_causal_attention(
            *(x[:, :200] for x in xs[:4]), xs[4][:399])
    with pytest.raises(TypeError):         # float16
        relpos_attention.relpos_causal_attention(*(x.half() for x in xs))
    with pytest.raises(ValueError):        # dk 64
        relpos_attention.relpos_causal_attention(
            *(x[..., :64].contiguous() for x in xs))


def _i8(g, *shape):
    return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)


@pytest.mark.parametrize("m,v,d", [(1, 128256, 2048), (4, 1000, 256),
                                   (8, 4097, 2048), (8, 300, 8192),
                                   (3, 33, 16)])
def test_logits_int8_matches_plain(dev, m, v, d):
    """Ragged V (no multiple of the 32 rows a block takes), M in {1, 3, 4,
    8}, and D = 8192, where 8 rows of x do not fit in shared memory and
    the kernel takes two row tiles."""
    g = torch.Generator().manual_seed(14)
    table = _i8(g, v, d).to(dev)
    scale = (torch.randn(v, generator=g).abs() * 0.01 + 0.005).to(dev)
    x = (0.1 * torch.randn(m, d, generator=g)).to(dev, torch.bfloat16)
    out = int8_matmul.logits_int8(x, table, scale)
    ref = int8_matmul.logits_int8_plain(x, table, scale)
    torch.cuda.synchronize()
    assert out.shape == (m, v) and out.dtype == torch.float32
    assert _rel(out, ref) <= 1e-3
    assert torch.equal(int8_matmul.logits_int8(x, table, scale), out)
    # the last table rows and the scales reach the output
    zeroed = table.clone()
    zeroed[-1:] = 0
    moved = int8_matmul.logits_int8(x, zeroed, scale)
    assert _rel(moved[:, -1:], ref[:, -1:]) > 0.5
    lead = int8_matmul.logits_int8(x.reshape(1, m, d), table, scale)
    assert torch.equal(lead[0], out)


@pytest.mark.parametrize("m,d,n", [(1, 2048, 3072), (1, 8192, 2048),
                                   (4, 1024, 4096), (8, 1024, 4097),
                                   (2, 100, 1000), (13, 2048, 2048),
                                   (1, 16, 8)])
def test_matmul_int8_matches_plain(dev, m, d, n):
    """N no multiple of a column tile (and, at 4097, of the lane's load),
    D no multiple of 8, M past 4 (row tiles), split and unsplit plans, and
    one slice (D = 16) where the block applies the scale itself."""
    g = torch.Generator().manual_seed(15)
    w = _i8(g, d, n).to(dev)
    scale = ((torch.rand(n, generator=g) + 0.5) / 127.0).to(dev)
    x = torch.randn(m, d, generator=g).to(dev, torch.bfloat16)
    out = int8_matmul.matmul_int8(x, w, scale)
    ref = int8_matmul.matmul_int8_plain(x, w, scale)
    torch.cuda.synchronize()
    assert out.shape == (m, n) and out.dtype == torch.float32
    assert _rel(out, ref) <= 1e-3
    assert torch.equal(int8_matmul.matmul_int8(x, w, scale), out)
    # every slice of the contraction reaches the output
    rows = int8_matmul.split_plan(m, d, n, torch.cuda.get_device_properties(
        dev).multi_processor_count)[2]
    if rows < d:
        last = x.clone()
        last[:, -1:] = 0
        moved = int8_matmul.matmul_int8(last, w, scale)
        assert not torch.equal(moved, out)
    lead = int8_matmul.matmul_int8(x.reshape(1, m, d), w, scale)
    assert torch.equal(lead[0], out)


# every M = 1 shape of the decode-layout path: the Llama-1B and S3
# projections, fused qkv and gate-up, the Llama down projection
@pytest.mark.parametrize("d,n", [(1024, 1024), (1024, 3072), (1024, 4096),
                                 (2048, 1024), (2048, 2048), (2048, 3072),
                                 (2048, 16384), (8192, 2048)])
def test_matmul_int8_decode_shapes_match_plain(dev, d, n):
    """M = 1 in one launch: within 1e-3 of the plain version, the same bits
    twice, and the last contraction row reaching the output."""
    g = torch.Generator().manual_seed(18)
    w = _i8(g, d, n).to(dev)
    scale = ((torch.rand(n, generator=g) + 0.5) / 127.0).to(dev)
    x = torch.randn(1, d, generator=g).to(dev, torch.bfloat16)
    out = int8_matmul.matmul_int8(x, w, scale)
    ref = int8_matmul.matmul_int8_plain(x, w, scale)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= 1e-3
    assert torch.equal(int8_matmul.matmul_int8(x, w, scale), out)
    last = x.clone()
    last[:, -1] = 0
    assert not torch.equal(int8_matmul.matmul_int8(last, w, scale), out)


def test_matmul_int8_split_call_replays_in_a_graph(dev):
    """D = 8192 splits the contraction: a CUDA graph that captured the call
    gives the eager result's bits on every replay, and follows its input."""
    g = torch.Generator().manual_seed(19)
    d, n = 8192, 2048
    assert int8_matmul.split_plan(1, d, n, torch.cuda.get_device_properties(
        dev).multi_processor_count)[2] < d
    w = _i8(g, d, n).to(dev)
    scale = ((torch.rand(n, generator=g) + 0.5) / 127.0).to(dev)
    x = torch.randn(1, d, generator=g).to(dev, torch.bfloat16)
    first = int8_matmul.matmul_int8(x, w, scale)
    assert _rel(first, int8_matmul.matmul_int8_plain(x, w, scale)) <= 1e-3
    static_x = x.clone()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        int8_matmul.matmul_int8(static_x, w, scale)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = int8_matmul.matmul_int8(static_x, w, scale)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static_out, first)
    static_x.copy_(2 * x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static_out, int8_matmul.matmul_int8(2 * x, w, scale))


def test_int8_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 64, dtype=torch.bfloat16, device=dev)
    table = torch.zeros(100, 64, dtype=torch.int8, device=dev)
    scale = torch.ones(100, device=dev)
    with pytest.raises(TypeError):         # float weights
        int8_matmul.logits_int8(x, table.float(), scale)
    with pytest.raises(TypeError):         # float16 scales
        int8_matmul.logits_int8(x, table, scale.half())
    with pytest.raises(ValueError):        # D % 16 != 0
        int8_matmul.logits_int8(x[:, :40], table[:, :40].contiguous(), scale)
    with pytest.raises(ValueError):        # scale does not fit
        int8_matmul.logits_int8(x, table, scale[:99])
    with pytest.raises(ValueError):        # weights on the CPU
        int8_matmul.logits_int8(x, table.cpu(), scale)
    w = torch.zeros(64, 100, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):        # not contiguous
        int8_matmul.matmul_int8(x, table.T, scale)
    with pytest.raises(ValueError):        # D does not fit
        int8_matmul.matmul_int8(x[:, :32], w, scale)
    with pytest.raises(TypeError):         # uint8 weights
        int8_matmul.matmul_int8(x, w.to(torch.uint8), scale)


def test_bf16_head_matches_the_f32_head(dev):
    """The Llama's bf16 head on the tensor cores (bf16 products, f32 sums
    and output) against the same head as an f32 product over the table's
    f32 copy: logits within 1e-5 of max |logit|, and the same backward
    (the gradients of the hidden state and of the table bit for bit)."""
    from taste_spokenlm_tpu_torch.models.llama import _Bf16Head
    g = torch.Generator().manual_seed(9)
    w = _rand(g, 1000, 256, scale=0.05, dtype=torch.bfloat16).to(dev)
    x = _rand(g, 2, 70, 256, dtype=torch.bfloat16).to(dev)
    up = _rand(g, 2, 70, 1000).to(dev)
    grads = []
    for head in (_Bf16Head.apply,
                 lambda h, t: h.to(t.dtype).float() @ t.float().T):
        h, t = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = head(h, t)
        (out * up).sum().backward()
        grads.append((out.detach(), h.grad, t.grad))
    (o1, h1, w1), (o2, h2, w2) = grads
    assert o1.dtype == torch.float32
    assert ((o1 - o2).abs().max() / o2.abs().max()).item() <= 1e-5
    assert torch.equal(h1, h2) and torch.equal(w1, w2)
