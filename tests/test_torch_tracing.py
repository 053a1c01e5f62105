"""The port's tracer (utils/profiling.py) at TasteConfig.tiny() on the CPU:
off it records nothing and changes nothing; on, the spans of a
reconstruction, of the engine under four threads, of the train steps and
of set-up have the names, parents and call ids their sites give, the S3
counters agree with the returned lengths, counting is safe from many
threads, and a span mapped onto torch.profiler's clock by an anchor holds
the operation run inside it.  About 20 s on one worker."""

import sys
import threading
import time

import pytest
import torch

from taste_spokenlm_tpu_torch import kernels, quant
from taste_spokenlm_tpu_torch.config import TasteConfig
from taste_spokenlm_tpu_torch.models.flow import MaskedDiffWithXvec
from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM
from taste_spokenlm_tpu_torch.serving.server import TasteEngine
from taste_spokenlm_tpu_torch.train import optim, train_step
from taste_spokenlm_tpu_torch.utils import profiling

torch.set_num_threads(2)
STEPS, MEL_LEN = 24, 40


@pytest.fixture
def tracer():
    """The tracer reset, and off and reset again afterwards."""
    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return TasteForCausalLM(TasteConfig.tiny(), device="cpu").eval()


def _utterances(cfg, b=2, seed=0):
    w = cfg.audio_tower.whisper
    g = torch.Generator().manual_seed(seed)
    return {"spk": torch.randn(b, cfg.speech_decoder.spk_embed_dim,
                               generator=g),
            "ids": torch.randint(10, w.vocab_size, (b, 8), generator=g),
            "lens": torch.tensor([8, 6][:b]),
            "words": torch.tensor([[0, 0, 1, 1, 2, 3, 3, 4],
                                   [0, 1, 1, 2, 3, 3, 0, 0]][:b]),
            "mel": torch.randn(b, w.n_mels, 2 * w.max_source_positions,
                               generator=g)}


def _reconstruct(model):
    u = _utterances(model.config)
    return model.inference_reconstruction(
        u["spk"], u["ids"], u["lens"], u["words"], u["mel"],
        max_speech_steps=STEPS, mel_len_max=MEL_LEN,
        generator=torch.Generator().manual_seed(1))


def _tokenize(model):
    u = _utterances(model.config)
    engine = TasteEngine(model, model.config, token_buckets=(8,))
    return {"indices": torch.as_tensor(engine.tokenize(
        u["mel"][0].numpy(), u["ids"][0].tolist(), u["words"][0].tolist()))}


def _stage1_batch(cfg, b=2, seed=0):
    u = _utterances(cfg, b, seed)
    g = torch.Generator().manual_seed(seed + 1)
    s3 = cfg.speech_decoder.speech_token_size
    return {"speaker_embeds": u["spk"], "asr_token_ids": u["ids"],
            "asr_token_lengths": u["lens"], "asr_word_ids": u["words"],
            "audio_features": u["mel"],
            "speech_token_ids": torch.randint(0, s3, (b, 12), generator=g),
            "speech_token_lengths": torch.tensor([12, 9][:b])}


def _stage1(model_sd):
    """Two stage-1 steps (rvq phase) on a fresh copy of the weights ->
    the trainable parameters after them and the metrics."""
    m = TasteForCausalLM(TasteConfig.tiny(), device="cpu")
    m.load_state_dict(model_sd)
    mask = optim.trainable_mask(m, optim.STAGE1_PHASES["rvq"])
    opt = optim.make_optimizer(m, 1e-3, mask=mask, grad_clip=5.0)
    step = train_step.make_stage1_step(m, opt, trainable_mask=mask)
    for i in range(2):
        metrics = step(_stage1_batch(m.config, seed=i))
    out = {n: p.detach().clone() for n, p in m.named_parameters() if mask[n]}
    out.update({"metric." + k: v for k, v in metrics.items()})
    return out


def _flow(seed=0):
    """Two flow steps on a fresh tiny flow -> its parameters after them."""
    cfg = TasteConfig.tiny().flow
    torch.manual_seed(seed)
    flow = MaskedDiffWithXvec(cfg)
    opt = optim.make_optimizer(flow, 1e-3, grad_clip=5.0)
    step = train_step.make_flow_step(flow, opt)
    g = torch.Generator().manual_seed(seed)
    n_tok, n_mel = 10, 20
    batch = {"speech_token_ids": torch.randint(0, cfg.vocab_size, (2, n_tok),
                                               generator=g),
             "speech_token_lengths": torch.tensor([n_tok, n_tok - 3]),
             "feat": torch.randn(2, n_mel, cfg.output_size, generator=g),
             "feat_lengths": torch.tensor([n_mel, n_mel - 6]),
             "embedding": torch.randn(2, cfg.spk_embed_dim, generator=g)}
    for _ in range(2):
        step(batch)
    return {n: p.detach().clone() for n, p in flow.named_parameters()}


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.id),
                  key=lambda s: s.start_ns)


# ---------------------------------------------------------------------------
# off: nothing recorded, nothing changed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["reconstruct", "tokenize", "stage1"])
def test_off_records_nothing_and_on_changes_nothing(tracer, model, path):
    run = {"reconstruct": lambda: _reconstruct(model),
           "tokenize": lambda: _tokenize(model),
           "stage1": lambda: _stage1(model.state_dict())}[path]
    assert profiling.span("s3.step") is profiling.span("tower")
    kernels.reset_launch_counts()
    off = run()
    off_launches = kernels.launch_counts()
    assert profiling.spans() == [] and profiling.counters() == {}
    tracer.enable()
    kernels.reset_launch_counts()
    on = run()
    tracer.disable()
    assert kernels.launch_counts() == off_launches
    assert profiling.spans()
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k


# ---------------------------------------------------------------------------
# the call tree, the engine, the counters, the train steps, set-up
# ---------------------------------------------------------------------------


def test_reconstruction_span_tree(tracer, model):
    tracer.enable()
    _reconstruct(model)
    spans = tracer.spans()
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "reconstruct"
    assert {s.call for s in spans} == {root.call}
    assert len({s.thread for s in spans}) == 1
    top = [s.name for s in _children(spans, root)]
    n_steps = top.count("s3.step")
    assert top == ["tower", "s3.prefill"] + ["s3.step"] * n_steps \
        + ["flow", "hift"]
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.name == "s3.step":
            (read,) = _children(spans, s)
            assert read.name == "s3.done_read"
        if s.parent is not None:
            up = next(p for p in spans if p.id == s.parent)
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
    c = tracer.counters()
    # every step that ran is a span; a last one may only have read `done`
    assert c["s3.steps"] in (n_steps, n_steps - 1)


@pytest.mark.parametrize("sampling_k", [1, 25])
def test_s3_row_steps_live_from_lengths(tracer, model, sampling_k):
    """Rows capped at 2.5 x their prefix (about 20 and 25 tokens) stop at
    different steps of a 32-step decode."""
    u = _utterances(model.config)
    with torch.no_grad():
        enc = model.audio_tower(u["mel"], u["ids"], u["lens"], u["words"])
    tracer.enable()
    gen = model.speech_decoder.generate(
        u["spk"], enc["audio_unit_embeds"], enc["audio_unit_lengths"],
        u["ids"], u["lens"], max_steps=32, sampling_k=sampling_k,
        min_token_text_ratio=0.5, max_token_text_ratio=2.5,
        generator=torch.Generator().manual_seed(3))
    tracer.disable()
    c = tracer.counters()
    steps = c["s3.steps"]
    lengths = gen["speech_token_lengths"].tolist()
    assert min(lengths) + 1 < steps and len(set(lengths)) > 1
    assert c["s3.row_steps"] == len(lengths) * steps
    assert c["s3.row_steps_live"] == sum(min(n + 1, steps) for n in lengths)
    assert steps == min(32, max(lengths) + 1)


def test_engine_threads_lock_wait_and_service(tracer, model):
    engine = TasteEngine(model, model.config, token_buckets=(8,))
    u = _utterances(model.config)
    args = (u["mel"][0].numpy(), u["ids"][0].tolist(), u["words"][0].tolist())
    engine.tokenize(*args)
    tracer.enable()
    errors, per_thread = [], 3

    def worker():
        try:
            for _ in range(per_thread):
                engine.tokenize(*args)
        except Exception as e:  # reported by the assertion below
            errors.append(e)
    threads = [threading.Thread(target=worker) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    tracer.disable()
    assert not errors and not any(th.is_alive() for th in threads)
    spans = tracer.spans()
    by_call = {}
    for s in spans:
        if s.name.startswith("engine."):
            assert s.parent is None
            by_call.setdefault(s.call, []).append(s)
    assert len(by_call) == 4 * per_thread
    for call, group in by_call.items():
        names = sorted(s.name for s in group)
        assert names == ["engine.lock_wait", "engine.prepare",
                         "engine.tokenize"], call
        assert len({s.thread for s in group}) == 1
        wait = next(s for s in group if s.name == "engine.lock_wait")
        serve = next(s for s in group if s.name == "engine.tokenize")
        assert wait.end_ns <= serve.start_ns
    service = sorted((s for s in spans if s.name == "engine.tokenize"),
                     key=lambda s: s.start_ns)
    assert len({s.thread for s in service}) == 4
    for a, b in zip(service, service[1:]):
        assert a.end_ns <= b.start_ns


@pytest.mark.parametrize("kind", ["stage1", "flow"])
def test_train_step_spans(tracer, model, kind):
    tracer.enable()
    if kind == "stage1":
        _stage1(model.state_dict())
    else:
        _flow()
    tracer.disable()
    spans = tracer.spans()
    steps = sorted((s for s in spans if s.name == "train.step"),
                   key=lambda s: s.start_ns)
    assert len(steps) == 2
    for step in steps:
        kids = _children(spans, step)
        assert [s.name for s in kids] == ["train.forward", "train.backward",
                                          "train.optimizer"]
        for a, b in zip(kids, kids[1:]):
            assert a.end_ns <= b.start_ns
        assert all(s.call == step.call for s in kids)
    assert [s.name for s in spans if s.parent is None].count("train.step") \
        == 2


def test_setup_spans(tracer):
    tracer.enable()
    cfg = TasteConfig.tiny()
    m = TasteForCausalLM(cfg, device="cpu")
    quant.serving_state_dict(m.state_dict(), quant.serving_config(cfg, "int8"),
                             "int8")
    tracer.disable()
    names = [s.name for s in tracer.spans() if s.parent is None]
    assert names == ["setup.construct", "setup.serving_layout"]


# ---------------------------------------------------------------------------
# the recorder itself
# ---------------------------------------------------------------------------


def test_counters_and_spans_from_many_threads(tracer):
    """16 threads (more than the cores) counting and opening nested spans
    with the interpreter switching threads every microsecond: no update is
    lost and every parent is on its own thread."""
    tracer.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    n_threads, n = 16, 200

    def worker():
        for _ in range(n):
            with profiling.span("outer"):
                profiling.count("c", 1)
                with profiling.span("inner"):
                    profiling.count("c", 2)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    tracer.disable()
    assert not any(th.is_alive() for th in threads)
    assert tracer.counters() == {"c": 3 * n * n_threads}
    # a finished thread's ident may be given to a later one: the table
    # holds the native id of the last thread that had it
    natives = {}
    for th in threads:
        natives.setdefault(th.ident, set()).add(th.native_id)
    table = tracer.threads()
    assert all(table[i] in ids for i, ids in natives.items())
    spans = tracer.spans()
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans) == 2 * n * n_threads
    for s in spans:
        if s.name == "inner":
            up = by_id[s.parent]
            assert up.name == "outer" and up.thread == s.thread
            assert s.call == up.call
        else:
            assert s.parent is None and s.call == s.id


def test_reset_and_disable(tracer):
    tracer.enable()
    with profiling.span("a", call=7):
        profiling.count("n", 3)
    (s,) = tracer.spans()
    assert (s.name, s.call, s.parent) == ("a", 7, None)
    tracer.reset()
    assert tracer.spans() == [] and tracer.counters() == {}
    tracer.disable()
    with profiling.span("b"):
        profiling.count("n", 1)
    assert tracer.spans() == [] and tracer.counters() == {}


def test_anchor_maps_span_over_the_operation_inside_it(tracer):
    """Under a CPU torch.profiler, the program span around a matmul,
    mapped onto the profiler's clock by the benchmark's anchors, holds the
    profiler's aten::mm."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import program_trace
    a = torch.randn(256, 256)
    tracer.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        readings = program_trace.take_anchors("start")
        time.sleep(0.002)
        with profiling.span("matmul"):
            time.sleep(0.002)
            a @ a
            time.sleep(0.002)
    tracer.disable()
    events = prof.profiler.kineto_results.events()
    marks = {e.name(): (e.start_ns(), e.end_ns()) for e in events
             if e.name().startswith(program_trace.ANCHOR)}
    _, offset = program_trace.anchor_offset(marks, "start", readings)
    (mm,) = [e for e in events if e.name() == "aten::mm"]
    (span,) = tracer.spans()
    assert span.start_ns + offset <= mm.start_ns()
    assert mm.end_ns() <= span.end_ns + offset
