"""The flow-matching (OT-CFM) training slice of the PyTorch port against
the JAX package, on the CPU at TasteConfig.tiny() in float32: `flow_mel`,
the training loss of MaskedDiffWithXvec (ConditionalCFM.compute_loss) with
the cosine scheduler and classifier-free dropout, its gradients, and three
whole `make_flow_step` steps.

JAX's draws (t, z and the rows that keep their conditions) come from the
step's key by JAX's split chain and are handed to the port.

Tolerances as tests/test_torch_training.py's: TOL 1e-4 relative to the
reference's largest value, PARAM_TOL 0.1 of each tensor's largest change
after three Adam steps; the mel 1e-4 absolute.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taste_spokenlm_tpu.models.flow import MaskedDiffWithXvec as JaxFlow
from taste_spokenlm_tpu.ops import audio as jax_audio
from taste_spokenlm_tpu.train import optim as jax_optim
from taste_spokenlm_tpu.train import train_step as jax_train_step
from taste_spokenlm_tpu_torch import convert
from taste_spokenlm_tpu_torch.config import FlowConfig
from taste_spokenlm_tpu_torch.models import flow as flow_module
from taste_spokenlm_tpu_torch.models.flow import MaskedDiffWithXvec
from taste_spokenlm_tpu_torch.ops.audio import flow_mel
from taste_spokenlm_tpu_torch.train import optim, train_step

from torch_parity_common import t, tiny_pair

torch.set_num_threads(2)
TOL = 1e-4
PARAM_TOL = 0.1


@pytest.mark.parametrize("shape", [(40 * 256 + 100,), (2, 24 * 256)])
def test_flow_mel_matches_jax(shape):
    r = np.random.RandomState(0)
    tt = np.arange(shape[-1]) / 22050.0
    wav = (0.4 * np.sin(2 * np.pi * 220.0 * tt) + 0.05 * r.randn(*shape)
           ).astype(np.float32)
    ref = np.asarray(jax_audio.flow_mel(jnp.asarray(wav)))
    got = flow_mel(t(wav)).numpy()
    assert got.shape == ref.shape == (1 if len(shape) == 1 else shape[0],
                                      shape[-1] // 256, 80)
    assert np.max(np.abs(got - ref)) <= 1e-4


def _flow_cfg(changes=()):
    return FlowConfig.tiny().replace(**dict(changes))


@functools.lru_cache(maxsize=None)
def _flow_pair(changes=()):
    """(jax flow module, its params as numpy, the port's flow) with the tiny
    pair's flow weights and the config changed by `changes`."""
    jcfg, _, variables, _ = tiny_pair()
    params = jax.tree.map(np.asarray,
                          variables["params"]["voice_generator"]["flow"])
    jflow = JaxFlow(jcfg.flow.replace(**dict(changes)))
    port = MaskedDiffWithXvec(_flow_cfg(changes))
    port.load_state_dict(convert.to_torch(convert.flow_state(params, "")),
                         strict=True)
    return jflow, params, port


def _batch(cfg, seed: int = 0):
    """Two rows of S3 tokens (ragged) and their target mels (flow_mel of a
    seeded wav, the second row shorter)."""
    r = np.random.RandomState(seed)
    n_tok = 20
    n_mel = int(n_tok / cfg.input_frame_rate * 22050 / 256)
    wav = (0.3 * r.randn(2, n_mel * 256)).astype(np.float32)
    feat = flow_mel(t(wav), n_mels=cfg.output_size).numpy()
    feat_len = np.array([n_mel, n_mel - 9], np.int32)
    feat[1, feat_len[1]:] = 0.0
    return {"speech_token_ids": r.randint(0, cfg.vocab_size, (2, n_tok)
                                          ).astype(np.int32),
            "speech_token_lengths": np.array([n_tok, n_tok - 4], np.int32),
            "feat": feat, "feat_lengths": feat_len,
            "embedding": r.randn(2, cfg.spk_embed_dim).astype(np.float32)}


def _draws(key, cfg, feat_shape):
    """The JAX loss's draws from `key` (flow.py compute_loss's split)."""
    rng_t, rng_z, rng_cfg = jax.random.split(key, 3)
    b = feat_shape[0]
    return {"t": t(jax.random.uniform(rng_t, (b, 1, 1)))[:, 0, 0],
            "z": t(jax.random.normal(rng_z, feat_shape)),
            "keep": t(jax.random.uniform(rng_cfg, (b,))
                      > cfg.training_cfg_rate)}


def _port_batch(batch):
    return {k: t(v) if v.dtype == np.float32 else t(v).long()
            for k, v in batch.items()}


def _mixed_key(cfg, b: int = 2):
    """The first key whose classifier-free draw keeps one row's conditions
    and drops the other's (each branch of compute_loss runs)."""
    seed = 0
    while True:
        key = jax.random.PRNGKey(seed)
        keep = np.asarray(jax.random.uniform(jax.random.split(key, 3)[2], (b,))
                          > cfg.training_cfg_rate)
        if cfg.training_cfg_rate == 0 or (keep.any() and not keep.all()):
            return key
        seed += 1


@pytest.mark.parametrize("changes", [
    (), (("t_scheduler", "linear"), ("training_cfg_rate", 0.0))])
def test_flow_loss_and_gradients_match_jax(changes):
    """The training loss (MaskedDiffWithXvec.__call__) on JAX's draws: the
    cosine scheduler with classifier-free dropout (one row kept, one
    dropped), and the linear scheduler without it; with the default
    config every parameter's gradient against jax.grad too (1e-4 of the
    larger of the tensor's largest gradient and 1e-2 of the largest over
    all)."""
    jflow, params, port = _flow_pair(changes)
    cfg = _flow_cfg(changes)
    batch = _batch(cfg)
    key = _mixed_key(cfg)
    jb = [jnp.asarray(batch[k]) for k in train_step.FLOW_KEYS]

    def loss(p):
        return jflow.apply({"params": p}, key, *jb)["loss"]
    pb = _port_batch(batch)
    for p in port.parameters():
        p.grad = None
    got = port(*(pb[k] for k in train_step.FLOW_KEYS),
               **_draws(key, cfg, batch["feat"].shape))["loss"]
    if changes:
        ref = jax.jit(loss)(params)
        assert abs(got.item() - float(ref)) <= TOL * abs(float(ref))
        return
    ref, grads = jax.jit(jax.value_and_grad(loss))(params)
    got.backward()
    assert abs(got.item() - float(ref)) <= TOL * abs(float(ref))
    ref_sd = convert.flow_state(jax.tree.map(np.asarray, grads), "")
    floor = 1e-2 * max(np.max(np.abs(v)) for v in ref_sd.values())
    for name, p in port.named_parameters():
        err = np.max(np.abs(p.grad.numpy() - ref_sd[name]))
        assert err <= TOL * max(np.max(np.abs(ref_sd[name])), floor), name


@functools.lru_cache(maxsize=None)
def _jax_flow_run(lr: float, clip: float):
    jflow, params, _ = _flow_pair()
    tx = jax_optim.make_optimizer(lr, grad_clip=clip)
    state = jax_train_step.init_state(jax.random.PRNGKey(0), params, None, tx)
    step = jax_train_step.make_flow_step(jflow, tx, mesh=None, donate=False)
    cfg = _flow_cfg()
    metrics, draws, rng = [], [], jax.random.PRNGKey(0)
    for seed in range(3):
        batch = _batch(cfg, seed)
        rng, sub = jax.random.split(rng)
        draws.append(_draws(sub, cfg, batch["feat"].shape))
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, draws, jax.tree.map(np.asarray, state.params)


def test_three_flow_steps_match_jax():
    lr, clip = 1e-3, 1.0
    ref_metrics, draws, final = _jax_flow_run(lr, clip)
    _, params, _ = _flow_pair()
    port = MaskedDiffWithXvec(_flow_cfg())
    start = convert.flow_state(params, "")
    port.load_state_dict(convert.to_torch(start), strict=True)
    opt = optim.make_optimizer(port, lr, grad_clip=clip)
    step = train_step.make_flow_step(port, opt)
    for seed, d, ref in zip(range(3), draws, ref_metrics):
        got = step(_port_batch(_batch(_flow_cfg(), seed)), draws=d)
        assert set(got) == set(ref) == {"loss", "grad_norm"}
        for k in ref:
            assert abs(got[k].item() - ref[k]) <= TOL * abs(ref[k]), (k, got[k],
                                                                      ref[k])
    assert step.state.step == 3
    want = convert.flow_state(final, "")
    for name, p in port.named_parameters():
        change = np.max(np.abs(want[name] - start[name]))
        moved = np.max(np.abs(p.detach().numpy() - start[name]))
        assert moved > 0 and change > 0, name        # every tensor moved
        if name.endswith("self_attn.linear_k.bias"):
            # a key bias shifts each score row by a constant, which the
            # softmax ignores: its gradient is zero but for rounding, which
            # Adam turns into steps of either sign on either side; both
            # must stay far below one real step of lr
            assert max(change, moved) <= 0.1 * 3 * lr, name
        else:
            err = np.max(np.abs(p.detach().numpy() - want[name]))
            assert err <= PARAM_TOL * change, name


def test_flow_step_keeps_the_fused_dit_blocks_unfused(monkeypatch):
    """With fused_dit_serving on and a block shape the kernel takes, the
    training loss and its gradients run the unfused blocks (the kernel has
    no backward): no call of fused_dit_block, and the same loss and
    gradients as the unfused config; inference under no_grad still takes
    the kernel's route."""
    calls = []
    for name in ("fused_dit_block", "fused_dit_block_plain"):
        real = getattr(flow_module, name)
        monkeypatch.setattr(flow_module, name, functools.partial(
            lambda real, *a, **kw: calls.append(1) or real(*a, **kw), real))
    base = FlowConfig.tiny().replace(estimator_channels=(128, 128),
                                     estimator_attention_head_dim=64)
    cfg = base.replace(fused_dit_serving=True)
    torch.manual_seed(0)
    fused = MaskedDiffWithXvec(cfg)
    plain = MaskedDiffWithXvec(base)
    plain.load_state_dict(fused.state_dict(), strict=True)
    pb = _port_batch(_batch(cfg))
    key = _mixed_key(cfg)
    draws = _draws(key, cfg, tuple(pb["feat"].shape))
    losses, grads = [], []
    for model in (fused, plain):
        loss = model(*(pb[k] for k in train_step.FLOW_KEYS), **draws)["loss"]
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    assert not calls
    assert losses[0] == losses[1]
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name
    fused.inference(pb["speech_token_ids"], pb["speech_token_lengths"],
                    pb["embedding"], 48)
    assert calls


def _fused_cfg():
    """The tiny flow at a block shape the fused kernel takes."""
    return FlowConfig.tiny().replace(estimator_channels=(128, 128),
                                     estimator_attention_head_dim=64)


def test_fused_inference_reads_the_weights_a_flow_step_wrote():
    """A flow step writes the weights in place.  Fused inference after it
    must read the written weights, not the kernel layout made when the
    state dict was loaded: the same mel as the unfused config loaded
    with the stepped weights."""
    base = _fused_cfg()
    torch.manual_seed(0)
    fused = MaskedDiffWithXvec(base.replace(fused_dit_serving=True))
    pb = _port_batch(_batch(base))
    step = train_step.make_flow_step(
        fused, optim.make_optimizer(fused, 1e-2, grad_clip=1.0))
    step(pb, draws=_draws(_mixed_key(base), base, tuple(pb["feat"].shape)))
    plain = MaskedDiffWithXvec(base)
    plain.load_state_dict(fused.state_dict(), strict=True)
    mels = [m.inference(pb["speech_token_ids"], pb["speech_token_lengths"],
                        pb["embedding"], 48,
                        generator=torch.Generator().manual_seed(0))[0]
            for m in (fused, plain)]
    ref = mels[1].numpy()
    assert np.max(np.abs(mels[0].numpy() - ref)) <= TOL * np.max(np.abs(ref))


def test_fused_block_trains_its_weights_when_norm1_is_frozen():
    """A block whose norm1 is frozen but whose other weights train, on an
    input that needs no gradient, takes the unfused route: the kernel has
    no backward.  Its gradients equal the unfused block's."""
    torch.manual_seed(0)
    fused = flow_module.BasicTransformerBlock(128, 2, 64, fused=True)
    plain = flow_module.BasicTransformerBlock(128, 2, 64)
    plain.load_state_dict(fused.state_dict(), strict=True)
    x = torch.randn(2, 16, 128)
    valid = torch.ones(2, 16, dtype=torch.bool)
    valid[1, 10:] = False
    for block in (fused, plain):
        block.norm1.requires_grad_(False)
        block(x, key_valid=valid).square().sum().backward()
    for (name, p), q in zip(fused.named_parameters(), plain.parameters()):
        if name.startswith("norm1."):
            assert p.grad is None, name
        else:
            assert torch.equal(p.grad, q.grad), name
