"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and nvcc; each skips with a reason
elsewhere.  Run on the card with:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import pytest
import torch

from taste_spokenlm_tpu_torch.kernels import conv1d, flash_attention, fused_dit

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


@pytest.mark.parametrize("t,lens", [(904, (904, 700)), (452, (452, 452)),
                                    (130, (100, 130))])
def test_fused_dit_matches_plain(dev, t, lens):
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
    ref = fused_dit.fused_dit_block_plain(x, lengths, params, heads=heads,
                                          head_dim=hd)
    torch.cuda.synchronize()
    for bi, ln in enumerate(lens):
        d = (out[bi, :ln].float() - ref[bi, :ln].float()).abs().max().item()
        scale = ref[bi, :ln].float().abs().max().item()
        assert d <= 2e-2 * scale, (bi, d, scale)


@pytest.mark.parametrize("t,c,k,dil", [(7232, 256, 3, 1), (4100, 128, 11, 5),
                                       (1000, 128, 7, 3)])
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
