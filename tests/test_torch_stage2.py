"""The stage-2 slice of the PyTorch port against the JAX package, on the
CPU at TasteConfig.tiny() in float32: the losses (`kl_to_reference`,
`chunked_ce_kl`, `masked_log_likelihood`), the Llama with its adapters
off and with per-layer remat, the bf16 head's autograd function, the
spoken LM's teacher-forced forward in
its modes, the composite's users (`forward_spoken_llm` with the speech
measurement, `scoring`, `eval_metrics_stage2`, reconstruction in mode
"SpokenLLM"), the stage-2 mask and three whole `make_stage2_step` steps
with the in-graph KL to the frozen base.

JAX's random draws (threefry) are computed with JAX and handed to the
port: the continue-latent bridge's eps from the step's key, the S3 gumbel
and the voice generator's noise from the reconstruction's key.

Tolerances: f32 floats 1e-4 relative to the reference's largest value
(TOL; the same arithmetic summed in another order); the losses' own
parity 1e-5 relative (LOSS_TOL, as the JAX package holds its chunked
loss against the unchunked one); indices, labels and trajectories exact;
parameters after three Adam steps 0.1 of each tensor's largest change
(PARAM_TOL, as tests/test_torch_training.py says why); frozen parameters
bit-identical; the waveform 1e-3 absolute.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taste_spokenlm_tpu.models.taste import TasteForCausalLM as JaxTaste
from taste_spokenlm_tpu.ops import losses as jax_losses
from taste_spokenlm_tpu.train import optim as jax_optim
from taste_spokenlm_tpu.train import train_step as jax_train_step
from taste_spokenlm_tpu_torch import convert
from taste_spokenlm_tpu_torch.config import TasteConfig
from taste_spokenlm_tpu_torch.ops import losses
from taste_spokenlm_tpu_torch.ops.remat import apply_remat
from taste_spokenlm_tpu_torch.train import optim, train_step

from torch_parity_common import (_fill_spoken_lm, inputs, lm_inputs,
                                 port_model, rel_err, s3_gumbel, t, tiny_pair,
                                 voice_noise)

torch.set_num_threads(2)
TOL = 1e-4
LOSS_TOL = 1e-5
PARAM_TOL = 0.1
KEYS = train_step.STAGE2_KEYS

# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _scalar_err(got, ref) -> float:
    got, ref = float(np.asarray(got.detach() if torch.is_tensor(got) else got)), float(ref)
    return abs(got - ref) / max(abs(ref), 1e-12)


@pytest.mark.parametrize("masked", [True, False])
def test_kl_to_reference_matches_jax(masked):
    r = np.random.RandomState(0)
    student = (2 * r.randn(2, 5, 13)).astype(np.float32)
    teacher = (2 * r.randn(2, 5, 13)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool) if masked else None
    ref = jax_losses.kl_to_reference(
        jnp.asarray(student), jnp.asarray(teacher),
        None if mask is None else jnp.asarray(mask))
    got = losses.kl_to_reference(t(student), t(teacher),
                                 None if mask is None else t(mask))
    assert _scalar_err(got, ref) <= LOSS_TOL


@pytest.mark.parametrize("teacher,chunk", [
    (None, 4), ("ref_hidden", 4), ("ref_logits", 4), ("ref_hidden", 64)])
def test_chunked_ce_kl_matches_jax(teacher, chunk):
    """CE, KL and the gradient with respect to the student's hidden state,
    against JAX's chunked_ce_kl, with T = 9 (4 does not divide it); the
    precomputed teacher logits are shorter than T (Tr = 6, in bf16)."""
    r = np.random.RandomState(1)
    b, tt, h, v = 2, 9, 8, 17
    w = (r.randn(h, v) / np.sqrt(h)).astype(np.float32)
    hidden = r.randn(b, tt, h).astype(np.float32)
    labels = r.randint(0, v, (b, tt)).astype(np.int32)
    labels[1, 6:] = losses.IGNORE_ID
    ref_hidden = r.randn(b, tt, h).astype(np.float32)
    ref_logits = (r.randn(b, 6, v) * 2).astype(np.float32)
    kw_j, kw_p = {}, {}
    if teacher == "ref_hidden":
        kw_j["ref_hidden"], kw_p["ref_hidden"] = jnp.asarray(ref_hidden), t(ref_hidden)
    elif teacher == "ref_logits":
        kw_j["ref_logits"] = jnp.asarray(ref_logits, jnp.bfloat16)
        kw_p["ref_logits"] = t(ref_logits).to(torch.bfloat16)

    def jax_loss(hid):
        ce, kl = jax_losses.chunked_ce_kl(lambda x: x @ jnp.asarray(w), hid,
                                          jnp.asarray(labels), chunk_size=chunk,
                                          **kw_j)
        return ce + (0.0 if kl is None else 0.7 * kl), (ce, kl)
    (_, (ce_j, kl_j)), g_j = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(hidden))
    hid = t(hidden).requires_grad_()
    ce, kl = losses.chunked_ce_kl(lambda x: x @ t(w), hid, t(labels),
                                  chunk_size=chunk, **kw_p)
    (ce + (0.0 if kl is None else 0.7 * kl)).backward()
    assert _scalar_err(ce, ce_j) <= LOSS_TOL
    assert (kl is None) == (kl_j is None) == (teacher is None)
    if kl is not None:
        assert _scalar_err(kl, kl_j) <= LOSS_TOL
    assert rel_err(hid.grad.numpy(), g_j) <= LOSS_TOL
    if teacher == "ref_hidden":
        # the teacher gets no gradient: it is the frozen base
        assert not kw_p["ref_hidden"].requires_grad


@pytest.mark.parametrize("head_size", [0, 9])
def test_masked_log_likelihood_matches_jax(head_size):
    r = np.random.RandomState(2)
    logits = (3 * r.randn(1, 11, 13)).astype(np.float32)
    targets = r.randint(0, 13, (1, 11)).astype(np.int32)
    targets[0, [2, 7]] = losses.IGNORE_ID
    ref = jax_losses.masked_log_likelihood(jnp.asarray(logits),
                                           jnp.asarray(targets),
                                           head_size=head_size)
    got = losses.masked_log_likelihood(t(logits), t(targets),
                                       head_size=head_size)
    for g, rr in zip(got, ref):
        assert _scalar_err(g, rr) <= LOSS_TOL
    assert float(got[0]) != float(got[1])     # the control differs


# ---------------------------------------------------------------------------
# the Llama: adapters off, remat
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


def _lm_batch(cfg, seed: int = 1):
    return lm_inputs(cfg, seed)


def test_llama_disable_lora_matches_jax(pair):
    """The frozen-base forward (adapters off) against JAX's
    `disable_lora=True` forward; it differs from the adapter forward, and
    the base weights it reads are the model's own tensors."""
    cfg, model, variables, port = pair
    d = _lm_batch(cfg)
    ids, lens = d["llm_token_ids"], d["llm_token_lengths"]

    def fwd(m, i, n, off):
        return m.spoken_lm.language_model(input_ids=i, attention_lengths=n,
                                          disable_lora=off)["last_hidden"]
    lm = port.spoken_lm.language_model
    for off in (True, False):
        ref = model.apply(variables, jnp.asarray(ids), jnp.asarray(lens), off,
                          method=fwd)
        got = lm(input_ids=t(ids).long(), attention_lengths=t(lens).long(),
                 disable_lora=off)["last_hidden"]
        assert rel_err(got.detach().numpy(), ref) <= TOL, off
        if off:
            base = got.detach()
    assert rel_err(base.numpy(), got.detach().numpy()) > 1e-3
    q = lm.layers[0].self_attn.q_proj
    assert q.weight.data_ptr() == dict(port.named_parameters())[
        "spoken_lm.language_model.layers.0.self_attn.q_proj.weight"].data_ptr()


def test_bf16_head_autograd_is_the_f32_heads(monkeypatch):
    """The bf16 head's autograd function (the tensor-core product of the
    card's bf16 tables) with its product computed here as the f32 head's
    (the CPU has no bf16 product with f32 output): the same logits and
    the same gradients, bit for bit, of the hidden state and the table
    as the f32 head written out, for bf16 and f32 hidden states."""
    from taste_spokenlm_tpu_torch.models.llama import _Bf16Head
    real = torch.mm

    def mm(a, b, out_dtype=None):
        return real(a.float(), b.float()) if out_dtype else real(a, b)
    monkeypatch.setattr(torch, "mm", mm)
    r = np.random.RandomState(8)
    w = t(0.05 * r.randn(50, 16).astype(np.float32)).to(torch.bfloat16)
    up = t(r.randn(2, 7, 50).astype(np.float32))
    for dtype in (torch.bfloat16, torch.float32):
        x = t(r.randn(2, 7, 16).astype(np.float32)).to(dtype)
        res = []
        for head in (_Bf16Head.apply,
                     lambda h, tab: h.to(tab.dtype).float() @ tab.float().T):
            h, tab = x.clone().requires_grad_(), w.clone().requires_grad_()
            out = head(h, tab)
            (out * up).sum().backward()
            res.append((out.detach(), h.grad, tab.grad))
        for a, b in zip(*res):
            assert a.dtype == b.dtype and torch.equal(a, b), dtype


def test_llama_remat_gives_the_same_gradients(pair):
    """With `remat` the Llama checkpoints each layer (recomputed in the
    backward); every gradient of the stage-2 loss equals the one without
    it, the train-mode noise passed in."""
    cfg, _, variables, _ = pair
    variables = jax.tree.map(np.asarray, variables)
    d = _lm_batch(cfg)
    eps = t(np.random.RandomState(4).randn(2, 11, cfg.audio_tower.quantizer
                                           .codebook_dim).astype(np.float32))
    grads, recomputed = [], []
    for rm in (False, True):
        port = port_model(apply_remat(TasteConfig.tiny(), rm), variables)
        calls = []
        hook = port.spoken_lm.language_model.layers[0].register_forward_pre_hook(
            lambda *a: calls.append(1))
        out = port.forward_spoken_llm(*(t(d[k]).long() for k in KEYS),
                                      train=True, eps=eps, compute_ref_kl=True,
                                      return_text_logits=False,
                                      ce_chunk_size=4)
        out["loss"].backward()
        hook.remove()
        recomputed.append(len(calls))
        grads.append({n: p.grad.clone() for n, p in port.named_parameters()
                      if p.grad is not None})
    # base forward, adapter forward, and with remat the recompute
    assert recomputed == [2, 3]
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) > 20
    for name in grads[0]:
        assert torch.allclose(grads[0][name], grads[1][name], rtol=1e-6,
                              atol=1e-9), name


# ---------------------------------------------------------------------------
# the teacher-forced forward
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _variant(changes):
    """(jax config, jax model, variables, port) with the spoken LM's config
    changed by `changes` (a tuple of items) and its weights filled anew;
    the rest of the tiny pair's weights kept."""
    cfg0, _, variables, _ = tiny_pair()
    jcfg = cfg0.replace(spoken_lm=cfg0.spoken_lm.replace(**dict(changes)))
    model = JaxTaste(jcfg)
    d = {k: jnp.asarray(v) for k, v in inputs(jcfg).items()}
    lm = {k: jnp.asarray(v) for k, v in lm_inputs(jcfg).items()}
    shapes = jax.eval_shape(
        functools.partial(model.init, method=JaxTaste.init_all),
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), d["speaker_embeds"],
        d["asr_token_ids"], d["asr_token_lengths"], d["asr_word_ids"],
        d["audio_features"], jnp.zeros((2, 4), jnp.int32),
        jnp.full((2,), 4, jnp.int32), lm["llm_token_ids"],
        lm["llm_token_lengths"], lm["llm_word_ids"])
    var_np = jax.tree.map(np.asarray, variables)
    r = np.random.RandomState(100)
    var_np["params"]["spoken_lm"] = jax.tree_util.tree_map_with_path(
        lambda p, x: _fill_spoken_lm(p, x, r), shapes["params"]["spoken_lm"])
    pcfg = TasteConfig.tiny()
    pcfg = pcfg.replace(spoken_lm=pcfg.spoken_lm.replace(**dict(changes)))
    return (jcfg, model, jax.tree.map(jnp.asarray, var_np),
            port_model(pcfg, var_np))


def _slm_pair(variant):
    return tiny_pair() if not variant else _variant(variant)


def _jax_slm(model, variables, batch, **kw):
    fn = lambda m, *a: m.spoken_lm(m._cb(), *a, **kw)  # noqa: E731
    return jax.jit(lambda v, *a: model.apply(v, *a, method=fn))(
        variables, *(jnp.asarray(batch[k]) for k in KEYS))


def _port_slm(port, batch, **kw):
    return port.spoken_lm(port._cb(), *(t(batch[k]).long() for k in KEYS), **kw)


def _total(cfg, batch) -> int:
    d = cfg.spoken_lm.delay
    return batch["llm_token_ids"].shape[1] + (d + 1 if d else 0)


FORWARD_CASES = {
    "eval": ((), {}),
    "lean": ((), dict(return_text_logits=False, ce_chunk_size=4)),
    "ref_kl": ((), dict(compute_ref_kl=True)),
    "ref_kl_lean": ((), dict(compute_ref_kl=True, return_text_logits=False,
                             ce_chunk_size=3)),
    "train": ((), dict(train=True, compute_ref_kl=True,
                       return_text_logits=False)),
    "linear_last": ((("out_llm_module", "linear_last"),),
                    dict(compute_ref_kl=True)),
    "token_delay": ((("delay_level", "token"),), dict(train=True)),
    # JAX's frozen-base teacher covers [sos | tokens], one row more than
    # the no-delay stream, so the no-delay case runs without it
    "no_delay": ((("delay", 0),), dict(train=True, return_text_logits=False,
                                       ce_chunk_size=4)),
}


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_spoken_lm_forward_matches_jax(case):
    """TasteSpokenLM.forward against JAX's __call__: losses and logits
    within TOL, labels and taste decisions exact.  Train mode hands the
    port JAX's eps from the same key."""
    variant, kw = FORWARD_CASES[case]
    cfg, model, variables, port = _slm_pair(variant)
    batch = _lm_batch(cfg)
    kw_j, kw_p = dict(kw), dict(kw)
    if kw.get("train"):
        key = jax.random.PRNGKey(11)
        shape = (2, _total(cfg, batch), cfg.audio_tower.quantizer.codebook_dim)
        kw_j["rng"] = key
        kw_p["eps"] = t(jax.random.normal(key, shape))
    ref = _jax_slm(model, variables, batch, **kw_j)
    with torch.no_grad():
        got = _port_slm(port, batch, **kw_p)
    assert set(got) == set(ref), (set(got) ^ set(ref))
    for k in ("text_labels", "taste_labels", "output_lengths"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    for k in ("loss", "text_loss", "taste_loss", "text_kl"):
        if k in ref:
            assert _scalar_err(got[k], ref[k]) <= TOL, (k, float(got[k]),
                                                        float(ref[k]))
    if "text_logits" in ref:
        assert rel_err(got["text_logits"].numpy(), ref["text_logits"]) <= TOL
    np.testing.assert_array_equal(got["taste_logits"].argmax(-1).numpy(),
                                  np.asarray(ref["taste_logits"]).argmax(-1))
    if dict(variant).get("out_llm_module") == "linear_last":
        assert rel_err(got["taste_logits"].numpy(), ref["taste_logits"]) <= TOL
    if kw.get("compute_ref_kl"):
        assert float(got["text_kl"]) > 1e-4       # the adapters moved it


@pytest.mark.parametrize("supplied", ["ref_hidden_in_graph", "ref_logits"])
def test_chunked_matches_unchunked(pair, supplied):
    """The port's own chunked path against its unchunked one, the JAX
    package's test_chunked_ce_kl_matches_unchunked and
    test_chunked_ce_with_precomputed_ref_logits cases: the teacher computed
    in the step, or supplied as the base's logits."""
    cfg, _, _, port = pair
    batch = _lm_batch(cfg)
    kw = {"compute_ref_kl": True}
    if supplied == "ref_logits":
        ids = t(batch["llm_token_ids"]).long()
        lens = t(batch["llm_token_lengths"]).long()
        ref_ids = torch.cat([torch.full((2, 1), cfg.spoken_lm.sos_id), ids], 1)
        lm = port.spoken_lm.language_model
        with torch.no_grad():
            kw = {"ref_logits": lm.logits(lm(
                input_ids=ref_ids, attention_lengths=lens + 1,
                disable_lora=True)["last_hidden"])}
    with torch.no_grad():
        full = _port_slm(port, batch, **kw)
        lean = _port_slm(port, batch, return_text_logits=False,
                         ce_chunk_size=3, **kw)
    assert "text_logits" not in lean and "text_kl" in lean
    for k in ("loss", "text_loss", "taste_loss", "text_kl"):
        assert _scalar_err(lean[k], full[k]) <= LOSS_TOL, k


# ---------------------------------------------------------------------------
# the composite's users
# ---------------------------------------------------------------------------


def _composite_batch(cfg):
    """The tiny asr inputs, llm tokens on the same words, S3 targets."""
    d = inputs(cfg)
    r = np.random.RandomState(6)
    d["llm_token_ids"] = r.randint(2, cfg.spoken_lm.llama.vocab_size,
                                   d["asr_token_ids"].shape).astype(np.int32)
    d["llm_token_lengths"] = d["asr_token_lengths"]
    d["llm_word_ids"] = d["asr_word_ids"]
    d["speech_token_ids"] = r.randint(
        0, cfg.speech_decoder.speech_token_size, (2, 12)).astype(np.int32)
    d["speech_token_lengths"] = np.array([12, 9], np.int32)
    return d


ASR = ("asr_token_ids", "asr_token_lengths", "asr_word_ids")
LLM = ("llm_token_ids", "llm_token_lengths", "llm_word_ids")


def _jit_apply(model, fn):
    return jax.jit(lambda v, *a: model.apply(v, *a, method=fn))


def test_forward_spoken_llm_with_speech_measurement_matches_jax(pair):
    """extract_vq, then forward_spoken_llm with the speech decoder on the
    predicted taste (the JAX package's
    test_stage2_forward_with_speech_measurement), and eval_metrics_stage2
    on both sides' outputs."""
    cfg, model, variables, port = pair
    d = _composite_batch(cfg)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    _, llm_idx = _jit_apply(model, JaxTaste.extract_vq)(
        variables, *(j[k] for k in ASR + LLM), j["audio_features"])
    ref = _jit_apply(model, JaxTaste.forward_spoken_llm)(
        variables, llm_idx, *(j[k] for k in LLM), j["speaker_embeds"],
        *(j[k] for k in ASR), j["speech_token_ids"], j["speech_token_lengths"])
    p = {k: t(v).long() for k, v in d.items()
         if k not in ("speaker_embeds", "audio_features")}
    _, idx = port.extract_vq(*(p[k] for k in ASR + LLM),
                             t(d["audio_features"]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(llm_idx))
    with torch.no_grad():
        got = port.forward_spoken_llm(
            idx, *(p[k] for k in LLM), t(d["speaker_embeds"]),
            *(p[k] for k in ASR), p["speech_token_ids"],
            p["speech_token_lengths"])
    np.testing.assert_array_equal(got["speech_labels"].numpy(),
                                  np.asarray(ref["speech_labels"]))
    assert rel_err(got["speech_logits"].numpy(), ref["speech_logits"]) <= TOL
    for k in ("loss", "text_loss", "taste_loss", "speech_token_accuracy"):
        assert _scalar_err(got[k], ref[k]) <= TOL, k
    m_ref = jax_train_step.eval_metrics_stage2(
        ref, cfg.audio_tower.quantizer.num_quantizers)
    m_got = train_step.eval_metrics_stage2(
        got, cfg.audio_tower.quantizer.num_quantizers)
    assert set(m_got) == set(m_ref)
    for k in m_ref:
        assert float(m_got[k]) == pytest.approx(float(m_ref[k]), abs=1e-7), k


def test_scoring_matches_jax(pair):
    cfg, model, variables, port = pair
    d = _composite_batch(cfg)
    args = [d[k] for k in ASR + LLM] + [d["audio_features"]]
    ref = _jit_apply(model, JaxTaste.scoring)(variables, *map(jnp.asarray, args))
    got = port.scoring(*(t(a).long() for a in args[:-1]), t(args[-1]))
    assert np.isfinite(float(got))
    assert _scalar_err(got, ref) <= TOL


def test_spoken_llm_reconstruction_matches_jax(pair):
    """inference_reconstruction(mode="SpokenLLM") on JAX's S3 gumbel and
    voice draws: the S3 tokens equal, the waveform within 1e-3."""
    cfg, model, variables, port = pair
    d = _composite_batch(cfg)
    steps, mel_len = 16, 32
    rng = jax.random.PRNGKey(7)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    ref = jax.jit(lambda v, *a: model.apply(
        v, rng, *a, mode="SpokenLLM", max_speech_steps=steps,
        mel_len_max=mel_len, method=JaxTaste.inference_reconstruction))(
            variables, j["speaker_embeds"], *(j[k] for k in ASR),
            j["audio_features"], *(j[k] for k in LLM))
    rng_dec, rng_voc = jax.random.split(rng)
    z, phase, noise = voice_noise(rng_voc, 2, mel_len, cfg)
    got = port.inference_reconstruction(
        t(d["speaker_embeds"]), *(t(d[k]).long() for k in ASR),
        t(d["audio_features"]), mode="SpokenLLM", max_speech_steps=steps,
        mel_len_max=mel_len, llm_token_ids=t(d["llm_token_ids"]).long(),
        llm_token_lengths=t(d["llm_token_lengths"]).long(),
        llm_word_ids=t(d["llm_word_ids"]).long(),
        gumbel=s3_gumbel(cfg, rng_dec, steps, 2), z=t(z),
        source_phase=t(phase), source_noise=t(noise))
    for k in ("speech_token_ids", "speech_token_lengths", "waveform_lengths"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert (got["speech_token_lengths"].numpy() > 0).all()
    wav = got["waveform"].numpy()
    assert np.isfinite(wav).all() and np.abs(wav).max() > 1e-4
    assert np.max(np.abs(wav - np.asarray(ref["waveform"]))) <= 1e-3
    # the taste it synthesised is the spoken LM's, not the tower's
    tower = port.inference_reconstruction(
        t(d["speaker_embeds"]), *(t(d[k]).long() for k in ASR),
        t(d["audio_features"]), max_speech_steps=steps, mel_len_max=mel_len,
        gumbel=s3_gumbel(cfg, rng_dec, steps, 2), z=t(z),
        source_phase=t(phase), source_noise=t(noise))
    assert not torch.equal(tower["speech_token_ids"], got["speech_token_ids"])


# ---------------------------------------------------------------------------
# the stage-2 mask and step
# ---------------------------------------------------------------------------


def _jax_mask_state_dict(variables, mask):
    """A JAX mask tree as 1.0 / 0.0 through the port's converter
    (weight-norm pairs of 0.0 collapse to NaN: frozen)."""
    ones = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m),
                                             np.float32),
                        mask, variables["params"])
    with np.errstate(invalid="ignore"):
        return convert.params_to_state_dict(
            {"params": ones, "quantizer": variables["quantizer"]})


def test_lora_only_mask_selects_the_jax_leaves(pair):
    _, _, variables, _ = pair
    variables = jax.tree.map(np.asarray, variables)
    port = port_model(TasteConfig.tiny(), variables)
    sd = _jax_mask_state_dict(variables,
                              jax_optim.lora_only_mask(variables["params"]))
    got = optim.lora_only_mask(port)
    assert list(got) == [n for n, _ in port.named_parameters()]
    for name, trainable in got.items():
        assert trainable == bool(np.all(sd[name] == 1.0)), name
    names = [n for n, v in got.items() if v]
    assert any(n.endswith("lora_B") for n in names)
    assert not any("embed_tokens" in n for n in names)
    assert 0 < len(names) < len(got)


def _stage2_batches(cfg):
    return [{k: t(v).long() for k, v in lm_inputs(cfg, seed).items()}
            for seed in (1, 2, 3)]


@functools.lru_cache(maxsize=None)
def _jax_stage2_run(lr: float, clip: float):
    """Three JAX make_stage2_step steps (use_ref_kl, lora_only_mask) from
    the tiny weights -> (per-step metrics, each step's eps, the final
    variables as numpy)."""
    cfg, model, variables, _ = tiny_pair()
    params = variables["params"]
    mask = jax_optim.lora_only_mask(params)
    tx = jax_optim.make_optimizer(lr, mask=mask, grad_clip=clip)
    state = jax_train_step.init_state(jax.random.PRNGKey(0), params,
                                      variables["quantizer"], tx)
    step = jax_train_step.make_stage2_step(model, tx, mesh=None,
                                           use_ref_kl=True, donate=False,
                                           trainable_mask=mask)
    dc = cfg.audio_tower.quantizer.codebook_dim
    metrics, eps, rng = [], [], jax.random.PRNGKey(0)
    for batch in _stage2_batches(TasteConfig.tiny()):
        rng, sub = jax.random.split(rng)
        shape = (2, _total(cfg, batch), dc)
        eps.append(t(jax.random.normal(sub, shape)))
        state, m = step(state, {k: jnp.asarray(v.numpy())
                                for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    final = jax.tree.map(np.asarray, {"params": state.params,
                                      "quantizer": state.quantizer})
    return metrics, eps, final


def test_three_stage2_steps_match_jax(pair):
    lr, clip = 1e-3, 1.0
    ref_metrics, eps, final = _jax_stage2_run(lr, clip)
    variables = jax.tree.map(np.asarray, pair[2])
    port = port_model(TasteConfig.tiny(), variables)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    mask = optim.lora_only_mask(port)
    opt = optim.make_optimizer(port, lr, mask=mask, grad_clip=clip)
    step = train_step.make_stage2_step(port, opt, use_ref_kl=True,
                                       trainable_mask=mask)
    for batch, e, ref in zip(_stage2_batches(TasteConfig.tiny()), eps,
                             ref_metrics):
        got = step(batch, draws={"eps": e})
        assert set(got) == set(ref) == {"loss", "text_loss", "taste_loss",
                                        "text_kl", "grad_norm"}
        for k in ref:
            assert _scalar_err(got[k], ref[k]) <= TOL, (k, got[k], ref[k])
    assert step.state.step == 3
    want = convert.params_to_state_dict(final)
    start = convert.params_to_state_dict(variables)
    moved = 0
    for name, value in port.state_dict().items():
        if name in mask and not mask[name] or name not in mask:
            assert torch.equal(value, before[name]), name
            continue
        got, ref = value.numpy(), want[name]
        change = np.max(np.abs(ref - start[name]))
        assert (np.max(np.abs(got - start[name])) > 0) == (change > 0), name
        moved += change > 0
        assert np.max(np.abs(got - ref)) <= PARAM_TOL * change, name
    lora_b = [n for n in mask if n.endswith("lora_B")]
    assert lora_b and all(not torch.equal(port.state_dict()[n], before[n])
                          for n in lora_b)
    assert moved > len(lora_b)


def test_stage2_gradients_match_jax(pair):
    """The raw gradients of the first step, every trainable tensor, against
    jax.grad of the JAX forward with the same key (1e-4 of the larger of
    each tensor's largest gradient and 1e-2 of the largest over all)."""
    cfg, model, variables, _ = pair
    batch = _stage2_batches(TasteConfig.tiny())[0]
    _, eps, _ = _jax_stage2_run(1e-3, 1.0)
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

    def loss(params):
        out = model.apply({"params": params, "quantizer": variables["quantizer"]},
                          *(jb[k] for k in KEYS), train=True, rng=sub,
                          compute_ref_kl=True, return_text_logits=False,
                          method=JaxTaste.forward_spoken_llm)
        return out["loss"]
    grads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(variables["params"]))
    with np.errstate(invalid="ignore"):
        ref = convert.params_to_state_dict(
            {"params": grads, "quantizer": variables["quantizer"]})
    port = port_model(TasteConfig.tiny(), jax.tree.map(np.asarray, variables))
    mask = optim.lora_only_mask(port)
    optim.apply_mask(port, mask)
    out = port.forward_spoken_llm(*(batch[k] for k in KEYS), train=True,
                                  eps=eps[0], compute_ref_kl=True,
                                  return_text_logits=False)
    out["loss"].backward()
    params = {n: p for n, p in port.named_parameters() if mask[n]}
    assert all(p.grad is None for n, p in port.named_parameters()
               if not mask[n])
    floor = 1e-2 * max(np.max(np.abs(ref[n])) for n in params)
    for name, p in params.items():
        err = np.max(np.abs(p.grad.numpy() - ref[name]))
        assert err <= TOL * max(np.max(np.abs(ref[name])), floor), name
