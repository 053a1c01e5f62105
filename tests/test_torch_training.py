"""The stage-1 training slice of the PyTorch port against the JAX package,
on the CPU at TasteConfig.tiny() in float32: the losses, the optimizer's
clip and schedules, the freeze masks, the RVQ's train forward with its EMA
update, a causal conformer stack at a kernel-eligible size, per-layer remat
and three whole `make_stage1_step` steps in each curriculum phase.

JAX's random draws (threefry) cannot be reproduced in torch: each test
computes, with JAX, the draws the JAX step makes from its key (the quantize
dropout level, the dead-code picks) and hands them to the port.

Tolerances: f32 floats 1e-4 relative to the reference's largest value
(the same arithmetic, summed in another order); indices and masks exact;
parameters after three Adam steps 0.1 of each tensor's largest change over
the steps (Adam scales each step to about lr whatever the gradient's size,
so a parameter is held to its movement, not its value, and an element with
a near-zero gradient moves by what its rounding gives: PARAM_TOL below);
frozen parameters bit-identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from taste_spokenlm_tpu.models import quantizer as jax_quantizer
from taste_spokenlm_tpu.ops import losses as jax_losses
from taste_spokenlm_tpu.train import optim as jax_optim
from taste_spokenlm_tpu.train import train_step as jax_train_step
from taste_spokenlm_tpu_torch import convert
from taste_spokenlm_tpu_torch.config import (EncoderStackConfig,
                                             QuantizerConfig, TasteConfig)
from taste_spokenlm_tpu_torch.models.conformer import ConformerEncoder
from taste_spokenlm_tpu_torch.models.quantizer import ResidualVQ
from taste_spokenlm_tpu_torch.ops import losses
from taste_spokenlm_tpu_torch.ops.remat import apply_remat
from taste_spokenlm_tpu_torch.train import optim, train_step

from torch_parity_common import (dead_picks, inputs, port_model, rel_err, t,
                                 tiny_pair)

torch.set_num_threads(2)
TOL = 1e-4
# after three Adam steps, relative to each tensor's largest change: Adam
# divides each gradient element by its own running scale, so an element
# whose gradient is near zero (cancellation in its f32 sums) takes a step
# set by its rounding, not by its value (up to 5.6e-2 measured, the S3
# stack's linear_pos); the gradients themselves are held at 1e-4 below
PARAM_TOL = 0.1

# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoothing,normalize", [(0.0, True), (0.1, True),
                                                 (0.0, False), (0.2, False)])
def test_label_smoothing_ce_matches_jax(smoothing, normalize):
    r = np.random.RandomState(0)
    logits = (3 * r.randn(3, 7, 11)).astype(np.float32)
    targets = r.randint(0, 11, (3, 7)).astype(np.int32)
    targets[0, 4:] = losses.IGNORE_ID
    targets[2, :] = losses.IGNORE_ID                # a row with no target
    ref = jax_losses.label_smoothing_ce(jnp.asarray(logits),
                                        jnp.asarray(targets), smoothing,
                                        normalize)
    got = losses.label_smoothing_ce(t(logits), t(targets).long(), smoothing,
                                    normalize)
    assert rel_err(got.item(), float(ref)) <= TOL
    acc = losses.masked_accuracy(t(logits), t(targets).long())
    assert acc.item() == pytest.approx(float(jax_losses.masked_accuracy(
        jnp.asarray(logits), jnp.asarray(targets))), abs=1e-7)


# ---------------------------------------------------------------------------
# optimizer: the clip, the schedules, the phase masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_matches_optax(max_norm):
    """Below the limit the gradients pass unchanged; above it they are
    scaled by max / norm (optax), not max / (norm + 1e-6) (torch)."""
    r = np.random.RandomState(1)
    grads = [r.randn(4, 5).astype(np.float32), r.randn(7).astype(np.float32)]
    ref, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], None)
    norm = optim.global_norm([t(g) for g in grads])
    assert rel_err(norm.item(), float(optax.global_norm(
        [jnp.asarray(g) for g in grads]))) <= 1e-6
    got = optim.clip_by_global_norm([t(g) for g in grads], max_norm)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if max_norm > norm.item():
        for a, g in zip(got, grads):
            np.testing.assert_array_equal(a.numpy(), g)


@pytest.mark.parametrize("dtypes,weight_decay,schedule", [
    (("float32",) * 3, 0.0, False),
    (("bfloat16",) * 3, 0.0, False),
    (("bfloat16", "float32", "bfloat16"), 0.0, True),
    (("bfloat16",) * 3, 1e-2, False),
    (("float32",) * 3, 1e-2, True)])
def test_optimizer_matches_optax(dtypes, weight_decay, schedule):
    """Three clipped Adam / AdamW updates of a small tree against optax's
    jitted chain: in bf16 (bench.py's tree, whose parameters and moments
    stay bf16) bit for bit; float32 leaves, alone or in a bf16 tree (the
    port's f32 segmenter), within 1e-6 of each tensor's largest value (XLA
    fuses the f32 update and rounds it in another order).  The clip acts
    on steps 1 and 3."""
    r = np.random.RandomState(2)
    shapes = [(24, 16), (40,), (8, 4, 3)]
    params = [(0.02 * r.randn(*s)).astype(np.float32) for s in shapes]
    grads = [[(scale * r.randn(*s)).astype(np.float32) for s in shapes]
             for scale in (0.3, 1e-3, 0.5)]
    lr = jax_optim.cosine_lr(1e-3, 1, 10) if schedule else 1e-3
    jd = [jnp.dtype(d) for d in dtypes]
    tx = jax_optim.make_optimizer(lr, weight_decay=weight_decay,
                                  grad_clip=1.0)
    jp = [jnp.asarray(p, d) for p, d in zip(params, jd)]
    state = tx.init(jp)

    @jax.jit
    def update(g, state, p):
        u, state = tx.update(g, state, p)
        return optax.apply_updates(p, u), state, optax.global_norm(g)

    model = torch.nn.Module()
    for i, (p, d) in enumerate(zip(params, dtypes)):
        model.register_parameter(f"p{i}", torch.nn.Parameter(
            t(p).to(getattr(torch, d))))
    opt = optim.make_optimizer(
        model, optim.cosine_lr(1e-3, 1, 10) if schedule else 1e-3,
        weight_decay=weight_decay, grad_clip=1.0)
    for g in grads:
        jp, state, ref_norm = update(
            [jnp.asarray(x, d) for x, d in zip(g, jd)], state, jp)
        for x, p in zip(g, opt.params):
            p.grad = t(x).to(p.dtype)
        norm = opt.step()
        assert rel_err(norm.item(), float(ref_norm)) <= 1e-6
    adam = state[-1][0]
    for got, ref, mu, ref_mu, nu, ref_nu in zip(opt.params, jp, opt.mu,
                                                adam.mu, opt.nu, adam.nu):
        assert got.dtype == mu.dtype == nu.dtype == getattr(torch, ref.dtype.name)
        for a, b in ((got, ref), (mu, ref_mu), (nu, ref_nu)):
            b = np.asarray(b, np.float32)
            tol = 0.0 if a.dtype == torch.bfloat16 else 1e-6 * np.max(np.abs(b))
            np.testing.assert_allclose(a.detach().float().numpy(), b, rtol=0,
                                       atol=tol)


@pytest.mark.parametrize("name,args", [
    ("warmuplr", (1e-3, 10)), ("constantlr", (1e-3, 10)),
    ("cosine", (2e-4, 5, 40, 1e-5)), ("square_annealing", (1e-3, 5, 40)),
    ("noam_hold", (1e-3, 5, 3, 0.5, 1e-5))])
def test_schedules_match_jax(name, args):
    ref = jax_optim.SCHEDULES[name](*args)
    got = optim.SCHEDULES[name](*args)
    for step in (0, 1, 3, 5, 7, 9, 10, 20, 39, 40, 60):
        assert got(step) == pytest.approx(float(ref(jnp.asarray(step))),
                                          rel=1e-6, abs=1e-12), step


_JAX_PHASES = {"text_only": [r"speech_decoder"],
               "no_vq": [r"audio_tower/decoder", r"speech_decoder"],
               "rvq": [r"audio_tower/decoder", r"audio_tower/vq",
                       r"speech_decoder"]}


def _jax_mask_state_dict(variables, phase):
    """JAX's trainable_mask with the scripts/train.py patterns, as a tree
    of 1.0 / 0.0 through the port's converter (weight-norm pairs of 0.0
    collapse to NaN: frozen)."""
    mask = jax_optim.trainable_mask(variables["params"],
                                    unfreeze_patterns=_JAX_PHASES[phase])
    ones = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m),
                                             np.float32),
                        mask, variables["params"])
    with np.errstate(invalid="ignore"):
        return convert.params_to_state_dict(
            {"params": ones, "quantizer": variables["quantizer"]})


@pytest.mark.parametrize("phase", ["text_only", "no_vq", "rvq"])
def test_phase_masks_select_the_jax_leaves(phase):
    _, _, variables, _ = tiny_pair()
    variables = jax.tree.map(np.asarray, variables)
    port = port_model(TasteConfig.tiny(), variables)
    sd = _jax_mask_state_dict(variables, phase)
    got = optim.trainable_mask(port, optim.STAGE1_PHASES[phase])
    assert list(got) == [n for n, _ in port.named_parameters()]
    for name, trainable in got.items():
        assert trainable == bool(np.all(sd[name] == 1.0)), name
    assert 0 < sum(got.values()) < len(got)


# ---------------------------------------------------------------------------
# the RVQ's train forward
# ---------------------------------------------------------------------------


def _rvq_pair(cfg, seed=0):
    """A JAX ResidualVQ and the port's, with the same weights and codebook
    state (cluster sizes near the dead-code threshold, so some codes
    expire)."""
    from taste_spokenlm_tpu.config import QuantizerConfig as JaxQCfg
    r = np.random.RandomState(seed)
    jcfg = JaxQCfg(**cfg.to_dict())
    mod = jax_quantizer.ResidualVQ(jcfg)
    x0 = jnp.zeros((2, 5, cfg.dim))
    shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0), x0)
    params = jax.tree.map(lambda s: (r.randn(*s.shape) / np.sqrt(s.shape[0])
                                     ).astype(np.float32), shapes["params"])
    q, k, d = cfg.num_quantizers, cfg.codebook_size, cfg.codebook_dim
    embed = (0.3 * r.randn(q, k, d)).astype(np.float32)
    sizes = (0.5 + 3 * r.rand(q, k)).astype(np.float32)
    quantizer = {"embed": embed, "embed_avg": embed * sizes[..., None],
                 "cluster_size": sizes, "initted": np.ones((), bool)}
    port = ResidualVQ(cfg)
    sd = convert.rvq_state_dict(params, quantizer, "")
    port.load_state_dict(convert.to_torch(sd), strict=True)
    return mod, {"params": params, "quantizer": quantizer}, port


@pytest.mark.parametrize("case", ["greedy", "dropped", "gumbel"])
def test_rvq_train_forward_matches_jax(case):
    """Indices exact, the commit loss, the straight-through gradient and the
    EMA buffers after the update (dead-code expiry included): greedy codes;
    a key whose quantize dropout drops levels; gumbel code sampling with
    JAX's noise."""
    cfg = QuantizerConfig.tiny().replace(
        dim=24, stochastic_sample_codes=case == "gumbel")
    mod, variables, port = _rvq_pair(cfg)
    r = np.random.RandomState(3)
    x = r.randn(2, 9, cfg.dim).astype(np.float32)
    mask = np.ones((2, 9), bool)
    mask[1, 6:] = False
    seed = 0
    while True:       # the first key whose draw drops a level, if asked
        key = jax.random.PRNGKey(seed)
        drop_after = int(jax.random.randint(key, (), 1, cfg.num_quantizers))
        if case != "dropped" or drop_after < cfg.num_quantizers - 1:
            break
        seed += 1
    gumbel = None
    if case == "gumbel":
        sample_key = jax.random.fold_in(key, 104729)
        gumbel = t(np.stack([np.asarray(jax.random.gumbel(
            jax.random.fold_in(sample_key, qi), (18, cfg.codebook_size)))
            for qi in range(cfg.num_quantizers)]))
    w = r.randn(2, 9, cfg.dim).astype(np.float32)

    def loss(params, xj):
        out, mutated = mod.apply({"params": params,
                                  "quantizer": variables["quantizer"]},
                                 xj, jnp.asarray(mask), train=True,
                                 dropout_rng=key, mutable=["quantizer"])
        return (jnp.sum(out["quantized_feats"] * w) + out["commit_loss"],
                (out, mutated["quantizer"]))
    (_, (ref, new_q)), (g_params, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))

    greedy = port(t(x), t(mask))["quantized_indices"]
    xt = t(x).requires_grad_()
    got = port(xt, t(mask), train=True, drop_after=drop_after, gumbel=gumbel,
               dead_picks=t(dead_picks(key, mask, drop_after, cfg)))
    (got["quantized_feats"] * t(w)).sum().add(got["commit_loss"]).backward()
    np.testing.assert_array_equal(got["quantized_indices"].numpy(),
                                  np.asarray(ref["quantized_indices"]))
    if case == "dropped":
        assert (got["quantized_indices"][..., -1] == -1).all()
    if case == "gumbel":         # the noise moved some code off the argmin
        assert (greedy != got["quantized_indices"]).any()
    assert rel_err(got["commit_loss"].item(), float(ref["commit_loss"])) <= TOL
    assert rel_err(got["quantized_feats"].detach().numpy(),
                   ref["quantized_feats"]) <= TOL
    assert rel_err(xt.grad.numpy(), g_x) <= TOL
    assert rel_err(port.project_in.weight.grad.numpy(),
                   np.asarray(g_params["project_in"]["kernel"]).T) <= TOL
    for name in ("embed", "embed_avg", "cluster_size"):
        want = np.asarray(new_q[name])
        for qi, level in enumerate(port.layers):
            buf = getattr(level._codebook, name)[0].numpy()
            assert rel_err(buf, want[qi]) <= TOL, (name, qi)
    # some codes expired and were re-seeded from batch rows
    old = variables["quantizer"]["cluster_size"]
    assert (old * cfg.decay < cfg.threshold_ema_dead_code).any()


def test_audio_dropout_matches_jax():
    """The tower's train forward with the batch-level audio dropout on
    (ratio 0.5; TasteConfig.full() has 0): a dropped row becomes JAX's
    noise at the batch std, a kept row its quantized embeds."""
    from taste_spokenlm_tpu.models.taste import TasteForCausalLM as JaxTaste
    cfg, _, variables, _ = tiny_pair()
    jcfg = cfg.replace(audio_tower=cfg.audio_tower.replace(
        audio_dropout_ratio=0.5))
    pcfg = TasteConfig.tiny()
    pcfg = pcfg.replace(audio_tower=pcfg.audio_tower.replace(
        audio_dropout_ratio=0.5))
    d = inputs(cfg)
    args = [jnp.asarray(d[k]) for k in ("audio_features", "asr_token_ids",
                                        "asr_token_lengths", "asr_word_ids")]
    seed = 0
    while True:        # a key that drops one row and keeps the other
        key = jax.random.PRNGKey(seed)
        noise_key, keep_key = jax.random.split(jax.random.fold_in(key, 1))
        keep = np.asarray(jax.random.bernoulli(keep_key, 0.5, (2, 1, 1)))
        if keep.any() and not keep.all():
            break
        seed += 1
    ref, _ = jax.jit(lambda v, *a: JaxTaste(jcfg).apply(
        v, *a, train=True, dropout_rng=key,
        method=lambda m, *b, **kw: m.audio_tower(*b, **kw),
        mutable=["quantizer"]))(variables, *args)
    q = cfg.audio_tower.quantizer
    drop_after = int(jax.random.randint(key, (), 1, q.num_quantizers))
    mask = np.arange(8)[None] < d["asr_token_lengths"][:, None]
    noise = jax.random.normal(noise_key, ref["audio_unit_embeds"].shape)
    port = port_model(pcfg, jax.tree.map(np.asarray, variables))
    got = port.audio_tower(*(t(d[k]) for k in (
        "audio_features", "asr_token_ids", "asr_token_lengths",
        "asr_word_ids")), train=True, draws={
            "drop_after": drop_after,
            "dead_picks": t(dead_picks(key, mask, drop_after, q)),
            "audio_keep": t(keep.reshape(2)), "audio_noise": t(noise)})
    np.testing.assert_array_equal(got["quantized_indices"].numpy(),
                                  np.asarray(ref["quantized_indices"]))
    assert rel_err(got["audio_unit_embeds"].detach().numpy(),
                   ref["audio_unit_embeds"]) <= TOL


# ---------------------------------------------------------------------------
# a causal conformer stack at a kernel-eligible size
# ---------------------------------------------------------------------------


def test_causal_stack_matches_jax_relpos_kernel(monkeypatch):
    """Two causal blocks at d_model 256, 2 heads (dk 128), T = 300 with
    ragged lengths: the port (plain path on the CPU) against the JAX stack
    on its Pallas rel-pos kernel (TASTE_FORCE_RELPOS_FLASH, interpret
    mode): outputs and every parameter gradient."""
    from taste_spokenlm_tpu.config import EncoderStackConfig as JaxStackCfg
    from taste_spokenlm_tpu.models.conformer import (
        ConformerEncoder as JaxConformer)
    from taste_spokenlm_tpu.ops.pallas import relpos_attention as RP
    cfg = EncoderStackConfig(input_size=64, output_size=256, attention_heads=2,
                             linear_units=128, num_blocks=2,
                             static_chunk_size=1, input_layer="linear")
    jenc = JaxConformer(JaxStackCfg(**cfg.to_dict()), dtype=jnp.float32)
    r = np.random.RandomState(0)
    x = (0.3 * r.randn(2, 300, 64)).astype(np.float32)
    lens = np.array([300, 250], np.int32)
    shapes = jax.eval_shape(jenc.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(lens))
    from torch_parity_common import random_params
    params = jax.tree.map(jnp.asarray, random_params(shapes, r))["params"]
    w = r.randn(2, 300, 256).astype(np.float32)
    monkeypatch.setenv("TASTE_FORCE_RELPOS_FLASH", "1")
    monkeypatch.setattr(RP, "_INTERPRET", [True])

    def apply(p):
        return jenc.apply({"params": p}, jnp.asarray(x), jnp.asarray(lens))
    ref_out = apply(params)
    grads = jax.grad(lambda p: jnp.sum(apply(p) * w))(params)

    port = ConformerEncoder(cfg)
    port.load_state_dict(convert.to_torch(convert.conformer_state(
        jax.tree.map(np.asarray, params), "")), strict=True)
    got = port(t(x), t(lens))
    (got * t(w)).sum().backward()
    assert rel_err(got.detach().numpy(), ref_out) <= TOL
    ref_sd = convert.conformer_state(jax.tree.map(np.asarray, grads), "")
    # linear_k's bias shifts a row's scores by one constant, which the
    # softmax ignores: its gradient is zero but for rounding, so each
    # gradient is held relative to the larger of its own largest value and
    # 1e-2 of the stack's
    floor = 1e-2 * max(np.max(np.abs(v)) for v in ref_sd.values())
    for name, p in port.named_parameters():
        err = np.max(np.abs(p.grad.numpy() - ref_sd[name]))
        assert err <= TOL * max(np.max(np.abs(ref_sd[name])), floor), name


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


def test_remat_gives_the_same_gradients():
    """Per-layer checkpointing recomputes each layer in the backward; the
    gradients are the same as without it."""
    _, _, variables, _ = tiny_pair()
    variables = jax.tree.map(np.asarray, variables)
    batch = _batches(TasteConfig.tiny())[0]
    grads = []
    for rm in (False, True):
        cfg = apply_remat(TasteConfig.tiny(), rm)
        model = port_model(cfg, variables)
        out = model.forward_speech_autoencoder(
            *(batch[k] for k in train_step.BATCH_KEYS), skip_vq=True)
        out["loss"].backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) > 50
    for name in grads[0]:
        assert torch.allclose(grads[0][name], grads[1][name], rtol=1e-6,
                              atol=1e-9), name


# ---------------------------------------------------------------------------
# the slice: three stage-1 steps
# ---------------------------------------------------------------------------


def _batches(cfg):
    """Three stage-1 batches: the tiny asr inputs with S3 targets of ragged
    lengths, the last with a row that has none."""
    base = inputs(cfg)
    r = np.random.RandomState(5)
    out = []
    for lens in ((12, 9), (10, 12), (12, 0)):
        ids = r.randint(0, cfg.speech_decoder.speech_token_size, (2, 12))
        out.append({**{k: t(v) for k, v in base.items()},
                    "speech_token_ids": t(ids.astype(np.int32)).long(),
                    "speech_token_lengths": t(np.array(lens, np.int32)).long()})
    for b in out:
        for k in ("asr_token_ids", "asr_token_lengths", "asr_word_ids"):
            b[k] = b[k].long()
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(phase: str, lr: float, clip: float):
    """Three JAX make_stage1_step steps from the tiny weights: -> (per-step
    metrics, the draws of each step, the final variables as numpy)."""
    cfg, model, variables, _ = tiny_pair()
    params = variables["params"]
    quantizer = variables["quantizer"]
    mask = jax_optim.trainable_mask(params, unfreeze_patterns=_JAX_PHASES[phase])
    tx = jax_optim.make_optimizer(lr, mask=mask, grad_clip=clip)
    state = jax_train_step.init_state(jax.random.PRNGKey(0), params, quantizer,
                                      tx)
    step = jax_train_step.make_stage1_step(
        model, tx, mesh=None, skip_vq=phase in ("text_only", "no_vq"),
        skip_audio_in_decoder=phase == "text_only", donate=False,
        trainable_mask=mask)
    qcfg = cfg.audio_tower.quantizer
    metrics, draws, rng = [], [], jax.random.PRNGKey(0)
    for batch in _batches(TasteConfig.tiny()):
        rng, sub = jax.random.split(rng)
        drop_after = int(jax.random.randint(sub, (), qcfg.quantize_dropout_cutoff_index,
                                            qcfg.num_quantizers))
        mask_bt = (np.arange(batch["asr_token_ids"].shape[1])[None]
                   < batch["asr_token_lengths"].numpy()[:, None])
        draws.append({"drop_after": drop_after, "dead_picks": t(
            dead_picks(sub, mask_bt, drop_after, qcfg))})
        jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        state, m = step(state, jb)
        metrics.append({k: float(v) for k, v in m.items()})
    final = jax.tree.map(np.asarray, {"params": state.params,
                                      "quantizer": state.quantizer})
    return metrics, draws, final


@pytest.mark.parametrize("phase", ["rvq", "text_only", "no_vq"])
def test_three_stage1_steps_match_jax(phase):
    lr, clip = 1e-3, 1.0
    ref_metrics, draws, final = _jax_run(phase, lr, clip)
    _, _, variables, _ = tiny_pair()
    variables = jax.tree.map(np.asarray, variables)
    port = port_model(TasteConfig.tiny(), variables)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    mask = optim.trainable_mask(port, optim.STAGE1_PHASES[phase])
    opt = optim.make_optimizer(port, lr, mask=mask, grad_clip=clip)
    step = train_step.make_stage1_step(
        port, opt, skip_vq=phase in ("text_only", "no_vq"),
        skip_audio_in_decoder=phase == "text_only", trainable_mask=mask)
    for batch, d, ref in zip(_batches(TasteConfig.tiny()), draws,
                             ref_metrics):
        got = step(batch, draws=d)
        assert set(got) == set(ref)
        for k in ref:
            assert rel_err(got[k].item(), ref[k]) <= TOL, (k, got[k], ref[k])
    assert step.state.step == 3
    want = convert.params_to_state_dict(final)
    start = convert.params_to_state_dict(variables)
    moved = 0
    for name, value in port.state_dict().items():
        got, ref = value.numpy(), want[name]
        if name in mask and not mask[name]:
            assert torch.equal(value, before[name]), name
            continue
        if name not in mask:                     # the RVQ's EMA buffers
            assert rel_err(got, ref) <= TOL, name
            continue
        change = np.max(np.abs(ref - start[name]))
        # a trainable tensor moves exactly where JAX's does (text_only
        # leaves the decoder's audio branch without a gradient)
        assert (np.max(np.abs(got - start[name])) > 0) == (change > 0), name
        moved += change > 0
        if name.endswith("self_attn.linear_k.bias"):
            # a key bias shifts each score row by a constant, which the
            # softmax ignores: its gradient is zero but for rounding, which
            # Adam turns into steps of either sign on either side; both
            # must stay far below one real step of lr
            assert max(change, np.max(np.abs(got - start[name]))) \
                <= 0.1 * 3 * lr, name
        else:
            assert np.max(np.abs(got - ref)) <= PARAM_TOL * change, name
    assert moved > 0


def test_stage1_gradients_match_jax():
    """The raw gradients of the rvq phase's first step, every trainable
    tensor, against jax.grad of the JAX forward with the same draws (1e-4
    of the larger of each tensor's largest gradient and 1e-2 of the
    largest over all: the key biases' gradients are zero but for
    rounding)."""
    from taste_spokenlm_tpu.models.taste import TasteForCausalLM as JaxTaste
    cfg, model, variables, _ = tiny_pair()
    batch = _batches(TasteConfig.tiny())[0]
    _, draws, _ = _jax_run("rvq", 1e-3, 1.0)
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

    def loss(params):
        out, _ = model.apply(
            {"params": params, "quantizer": variables["quantizer"]},
            *(jb[k] for k in train_step.BATCH_KEYS), train=True,
            dropout_rng=sub, method=JaxTaste.forward_speech_autoencoder,
            mutable=["quantizer"])
        return out["loss"]
    grads = jax.tree.map(np.asarray,
                         jax.jit(jax.grad(loss))(variables["params"]))
    with np.errstate(invalid="ignore"):
        ref = convert.params_to_state_dict(
            {"params": grads, "quantizer": variables["quantizer"]})
    port = port_model(TasteConfig.tiny(), jax.tree.map(np.asarray, variables))
    mask = optim.trainable_mask(port, optim.STAGE1_PHASES["rvq"])
    optim.apply_mask(port, mask)
    out = port.forward_speech_autoencoder(
        *(batch[k] for k in train_step.BATCH_KEYS), train=True,
        draws=draws[0])
    out["loss"].backward()
    params = {n: p for n, p in port.named_parameters() if mask[n]}
    floor = 1e-2 * max(np.max(np.abs(ref[n])) for n in params)
    for name, p in params.items():
        err = np.max(np.abs(p.grad.numpy() - ref[name]))
        assert err <= TOL * max(np.max(np.abs(ref[name])), floor), name
