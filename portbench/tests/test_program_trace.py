"""portbench/program_trace.py and the readers of the program's spans on
hand-made records: the clock's offset, launch attribution, idle within
spans, the breakdowns and each metric's arithmetic."""

import importlib

import pytest

from portbench import program_trace as pt_mod
from portbench.program_trace import NO_LAUNCH, NO_SPAN, Clock, ProgramTrace
from taste_spokenlm_tpu_torch.utils.profiling import Span

OFFSET = 1_000_000_000          # profiler ns - program ns
CLOCK = Clock((0, OFFSET))
MAIN, WORKER = 11, 12


def span(name, start, end, sid, parent=None, thread=MAIN, call=None):
    return Span(name, start, end, thread, sid, parent,
                sid if call is None else call)


def trace(ops, launches, window=(0, 10_000)):
    """Profiler-clock records from program-clock times."""
    return {"ops": [(s + OFFSET, e + OFFSET, c, n) for s, e, c, n in ops],
            "launches": {c: (t + OFFSET, th) for c, (t, th) in launches.items()},
            "marks": {pt_mod.WINDOW: (window[0] + OFFSET, window[1] + OFFSET)}}


def recon_trace():
    """One reconstruct call on the main thread: two S3 steps, each with its
    read of `done`, and device work launched in and outside them."""
    spans = [span("reconstruct", 100, 5000, 1),
             span("s3.step", 1000, 1990, 2, 1, call=1),
             span("s3.done_read", 1000, 1100, 3, 2, call=1),
             span("s3.step", 2000, 3000, 4, 1, call=1),
             span("s3.done_read", 2000, 2050, 5, 4, call=1),
             span("setup.construct", -900, -500, 6),
             span("kernels.load", -700, -300, 7),
             span("setup.serving_layout", -200, -100, 8)]
    ops = [(1500, 1700, 1, "gemm"),              # launched in step 2
           (1450, 1500, 2, "elementwise_copy"),  # in step 2's done_read
           (2500, 2900, 3, "gemm"),              # step 4, another thread id
           (3500, 3600, 4, "gemm"),              # in reconstruct only
           (3700, 3800, 5, "gemm"),              # no launch event
           (6000, 6100, 6, "gemm")]              # outside every span
    launches = {1: (1200, MAIN), 2: (1050, MAIN), 3: (2200, 99),
                4: (3100, MAIN), 6: (5500, MAIN)}
    return ProgramTrace(spans, {"s3.steps": 2, "s3.row_steps": 32,
                                "s3.row_steps_live": 24},
                        trace(ops, launches), CLOCK)


def read(metric, pt, suffix=""):
    return importlib.import_module(f"portbench.metrics.{metric}").read(
        {"program": pt}, suffix)


def test_anchor_offset_takes_the_narrowest_anchor():
    marks = {f"{pt_mod.ANCHOR}.start.0": (1000, 3000),
             f"{pt_mod.ANCHOR}.start.1": (5000, 5010),
             f"{pt_mod.ANCHOR}.start.2": (8000, 8100)}
    assert pt_mod.anchor_offset(marks, "start", [10, 4000, 7000]) == (
        4000, 5005 - 4000)
    with pytest.raises(RuntimeError):
        pt_mod.anchor_offset({}, "end", [])


def test_clock_moves_straight_between_anchors():
    """The offset is 1000 at program ns 0 and 1400 at program ns 4000."""
    clock = Clock((4000, 1400), (0, 1000))
    assert clock.drift == 400
    assert clock(1000) == 0 and clock(5400) == 4000
    assert clock(3000) == 3000 - 1000 - 200      # half way
    assert clock(-5000) == -6000 and clock(9400) == 8000
    assert Clock((7, 50))(100) == 50


def test_launch_attribution():
    pt = recon_trace()
    assert pt.window == (0, 10_000)
    got = [(s, e, span.name if span else None, t is not None)
           for s, e, _, span, t in pt.ops]
    assert got == [(1500, 1700, "s3.step", True),
                   (1450, 1500, "s3.done_read", True),
                   (2500, 2900, "s3.step", True),
                   (3500, 3600, "reconstruct", True),
                   (3700, 3800, None, False),
                   (6000, 6100, None, True)]
    assert pt.by_thread == 4          # the launch on thread 99 by time
    assert pt.device_ns_under("s3.step") == 200 + 50 + 400
    assert pt.device_ns_under("reconstruct") == 200 + 50 + 400 + 100
    assert pt.ops_before_their_span("s3.step") == (0, 0)
    assert pt.ops_before_launch() == (0, 0)
    assert pt.device_by_span() == pytest.approx(
        {"s3.step": 600e-9, "s3.done_read": 50e-9, "reconstruct": 100e-9,
         NO_LAUNCH: 100e-9, NO_SPAN: 100e-9})
    assert pt.device_by_span(pt_mod.COPIES) == pytest.approx(
        {"s3.done_read": 50e-9})


def test_an_op_before_its_span_is_found():
    spans = [span("s3.step", 1000, 2000, 1)]
    pt = ProgramTrace(spans, {}, trace([(900, 1100, 1, "k")],
                                       {1: (1500, MAIN)}), CLOCK)
    assert pt.ops_before_their_span("s3.step") == (1, 100)
    assert pt.ops_before_launch() == (1, 600)


def test_idle_within_spans_and_by_span():
    pt = recon_trace()
    assert pt.busy == [[1450, 1700], [2500, 2900], [3500, 3600],
                       [3700, 3800], [6000, 6100]]
    assert pt.idle_within(pt.named("s3.step")) == (990 + 1000 - 650,
                                                    990 + 1000)
    assert pt.idle_within(pt.named("s3.done_read")) == (150, 150)
    assert pt.idle_by_span() == pytest.approx(
        {"reconstruct": 4350e-9, "s3.step": 800e-9, NO_SPAN: 3900e-9})


def test_launch_threads_through_kineto_ids():
    """A worker's launch inside its service while another thread waits:
    kineto's id of the worker's thread picks the service, where time alone
    would pick the later-started wait."""
    spans = [span("engine.tokenize", 100, 900, 1, thread=WORKER, call=5),
             span("engine.lock_wait", 200, 950, 2, thread=MAIN, call=6)]
    ops, launches = [(400, 500, 1, "k")], {1: (300, 7)}
    blind = ProgramTrace(spans, {}, trace(ops, launches), CLOCK)
    assert blind.ops[0][3].name == "engine.lock_wait" and blind.by_thread == 0
    seen = ProgramTrace(spans, {}, trace(ops, launches), CLOCK,
                        threads={7: WORKER})
    assert seen.ops[0][3].name == "engine.tokenize" and seen.by_thread == 1


def test_kineto_threads():
    ids = pt_mod.kineto_threads({2 ** 40 + 5: 301, 17: 302})
    assert ids == {5: 2 ** 40 + 5, 17: 17, 301: 2 ** 40 + 5, 302: 17}


def test_idle_labels_join_the_threads():
    spans = [span("engine.tokenize", 100, 900, 1, thread=MAIN, call=5),
             span("engine.lock_wait", 200, 950, 2, thread=WORKER, call=6)]
    pt = ProgramTrace(spans, {}, trace([(100, 400, 1, "k")],
                                       {1: (150, MAIN)}, (0, 1000)), CLOCK)
    idle = pt.idle_by_span()
    assert idle == {"engine.lock_wait+engine.tokenize": pytest.approx(
        600e-9), NO_SPAN: pytest.approx(100e-9)}


def test_recon_readers():
    pt = recon_trace()
    assert read("recon_s3_live_row_share", pt) == 100.0 * 24 / 32
    assert read("recon_s3_sync_ms_per_step", pt) == pytest.approx(
        (100 + 50) / 1e6 / 2)
    assert read("recon_s3_step_device_ms", pt) == pytest.approx(
        650 / 1e6 / 2)
    # construct and kernels.load overlap: -900 .. -300, then -200 .. -100
    assert read("setup_program_s", pt, "recon") == pytest.approx(700e-9)


def test_tokenize_readers():
    """Three requests: waits 100, 300 and 500 ns, services 200 ns each,
    the card busy for half of each service; a reconstruct's wait is not a
    Tokenize request's."""
    spans = []
    for k, (wait, start) in enumerate([(100, 1000), (300, 2000),
                                       (500, 3000)]):
        spans += [span("engine.lock_wait", start - wait, start, 10 * k + 1,
                       call=k, thread=100 + k),
                  span("engine.tokenize", start, start + 200, 10 * k + 2,
                       call=k, thread=100 + k)]
    spans.append(span("engine.lock_wait", 4000, 9000, 99, call=7))
    ops = [(1000 + 1000 * k, 1100 + 1000 * k, k, "gemm") for k in range(3)]
    launches = {k: (1000 + 1000 * k, 100 + k) for k in range(3)}
    pt = ProgramTrace(spans, {}, trace(ops, launches), CLOCK)
    from portbench.common import percentile
    assert read("tokenize_lock_wait_ms_p95", pt) == pytest.approx(
        percentile([100, 300, 500], 95) / 1e6)
    assert read("tokenize_service_ms_p50", pt) == pytest.approx(200 / 1e6)
    assert read("tokenize_service_idle_share", pt) == pytest.approx(50.0)


def test_train_reader():
    """Two steps; the optimizer spans 400 ns each with 100 ns of device
    work in the first."""
    spans = []
    for k in range(2):
        base = 1000 + 2000 * k
        spans += [span("train.step", base, base + 1500, 10 * k + 1),
                  span("train.optimizer", base + 1000, base + 1400,
                       10 * k + 2, 10 * k + 1, call=10 * k + 1)]
    pt = ProgramTrace(spans, {}, trace([(2100, 2200, 1, "adam")],
                                       {1: (2050, MAIN)}), CLOCK)
    assert read("train_opt_idle_ms", pt) == pytest.approx(
        (300 + 400) / 1e6 / 2)


@pytest.mark.parametrize("metric", sorted(
    m.partition(".")[0] for ms in pt_mod.METRICS.values() for m, _ in ms))
def test_readers_find_nothing_in_an_empty_trace(metric):
    assert read(metric, None) is None
    empty = ProgramTrace([], {}, trace([], {}), CLOCK)
    assert read(metric, empty, "recon") is None
