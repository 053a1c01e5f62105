"""The yardstick's arithmetic at small shapes, against counts by hand: the
kernels' operations and bytes, the bound, the traffic generator, the
open-loop timing from due times, the trace reading and the statistics."""

import statistics
import threading
import time

import pytest

from portbench import common, generator
from portbench.rooflines import (bound_s, ffn_int8, flash_attention,
                                 fused_dit_block, relpos_causal_attention)


def test_bound_is_the_larger_of_the_two():
    assert bound_s(989e12, 0) == pytest.approx(1.0)
    assert bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_flash_counts():
    # b=2, t=3, h=1, d=4: QK^T and PV, 2*t*t*d each; q k v o of 2*3*4
    flops, n_bytes = flash_attention.work(2, 3, 1, 4, 2)
    assert flops == 2 * (2 * 3 * 3 * 4 + 2 * 3 * 3 * 4)
    assert n_bytes == 4 * (2 * 3 * 1 * 4) * 2


def test_ffn_int8_counts():
    flops, n_bytes = ffn_int8.work(rows=2, d=3, hidden=5)
    assert flops == 2 * 2 * 3 * 5 + 2 * 2 * 5 * 3
    # int8 W1 and W2, f32 s1 b1 (5 each) and s2 b2 (3 each), bf16 x and y
    assert n_bytes == 15 + 15 + 4 * (5 + 5 + 3 + 3) + 2 * 2 * 3 * 2


def test_dit_counts():
    t, c, heads, hd = 4, 8, 2, 4
    inner = heads * hd
    flops, n_bytes = fused_dit_block.work(t, [4, 2], c, heads, hd)
    m = 2 * t
    gemm = 2 * m * c * 3 * inner + 2 * m * inner * c + 2 * m * c * 4 * c * 2
    attn = 2 * heads * (2 * t * 4 * hd + 2 * t * 2 * hd)
    assert flops == gemm + attn
    weights = 3 * c * inner + inner * c + inner + 8 * c * c + 9 * c
    assert n_bytes == 2 * (2 * m * c + weights)


def test_dit_levels_follow_the_unet():
    # two levels: down 4 + 4, middle 12 x 4 at the lower, up 4 + 4
    calls = fused_dit_block.levels([904, 452], [256, 256], 4, 12, 10)
    assert calls == {0: 80, 1: 560}


def test_relpos_counts():
    assert relpos_causal_attention.pairs([3, 1]) == 6 + 1
    flops, n_bytes = relpos_causal_attention.forward(1, 3, 1, 2, [3])
    assert flops == 6 * 2 * 6
    n_el, p_el = 6, 5 * 2
    assert n_bytes == 2 * (4 * n_el + p_el) + 4 + 2 * n_el + 4 * 3
    bflops, _ = relpos_causal_attention.backward(1, 3, 1, 2, [3])
    assert bflops == 16 * 2 * 6


def _tiny():
    from taste_spokenlm_tpu_torch.config import TasteConfig
    return TasteConfig.tiny()


def test_flash_window_counts_the_encoder_layers():
    cfg = _tiny()
    w = cfg.audio_tower.whisper
    hd = w.d_model // w.encoder_heads
    shapes = {"cfg": cfg, "encoder": [{"rows": 2, "bytes": 4},
                                      {"rows": 1, "bytes": 4}]}
    out = flash_attention.window(shapes)
    assert out["calls"] == {"flash_attention": 2 * w.encoder_layers}
    one = bound_s(*flash_attention.work(1, w.max_source_positions,
                                        w.encoder_heads, hd, 4))
    assert out["bound_s"] == pytest.approx(3 * w.encoder_layers * one)
    assert flash_attention.window({"cfg": cfg}) is None


def test_ffn_window_counts_steps_and_a_small_prefill():
    cfg = _tiny()
    llm = cfg.speech_decoder.llm
    d, f, n = llm.output_size, llm.linear_units, llm.num_blocks
    small = {"rows": 2, "prefix": 5, "steps": 7}
    large = {"rows": 16, "prefix": 20, "steps": 3}
    out = ffn_int8.window({"cfg": cfg, "s3_decode": [small, large]})
    assert out["calls"] == {"ffn_int8": (7 + 1 + 3) * n}
    want = n * (7 * bound_s(*ffn_int8.work(2, d, f))
                + bound_s(*ffn_int8.work(10, d, f))
                + 3 * bound_s(*ffn_int8.work(16, d, f)))
    assert out["bound_s"] == pytest.approx(want)


def test_dit_window_counts_every_level_and_step():
    cfg = _tiny()
    fl = cfg.flow
    out = fused_dit_block.window({"cfg": cfg, "flow": [
        {"mel_len": 40, "frames": [40, 17]}]})
    n_ch = len(fl.estimator_channels)
    per_inference = (2 * n_ch + fl.estimator_num_mid_blocks) \
        * fl.estimator_n_blocks * fl.n_timesteps
    assert out["calls"] == {"fused_dit_block": per_inference}
    assert out["bound_s"] > 0


@pytest.mark.parametrize("remat", [False, True])
def test_relpos_window_counts_forwards_and_backwards(remat):
    cfg = _tiny()
    llm = cfg.speech_decoder.llm.replace(remat=remat)
    cfg = cfg.replace(speech_decoder=cfg.speech_decoder.replace(llm=llm))
    steps = [{"rows": 2, "width": 9, "lengths": [9, 4], "bytes": 2}] * 3
    out = relpos_causal_attention.window({"cfg": cfg, "s3_train": steps})
    n_fwd = 2 if remat else 1
    assert out["calls"] == {
        "relpos_causal_attention": 3 * n_fwd * llm.num_blocks,
        "relpos_causal_attention_bwd": 3 * llm.num_blocks}
    dk = llm.output_size // llm.attention_heads
    args = (2, 9, llm.attention_heads, dk, [9, 4], 2)
    want = 3 * llm.num_blocks * (
        n_fwd * bound_s(*relpos_causal_attention.forward(*args))
        + bound_s(*relpos_causal_attention.backward(*args)))
    assert out["bound_s"] == pytest.approx(want)


def _roofline_ctx(launches, ops, secs):
    cfg = _tiny()
    return {"shapes": {"cfg": cfg, "s3_train": [
                {"rows": 1, "width": 5, "lengths": [5], "bytes": 2}]},
            "launches": launches,
            "trace": {"ops": {"void fwd_kernel<64>(Args)": [ops[0], secs],
                              "void dkv_kernel<64>(Args)": [ops[1], secs]}}}


def test_roofline_reads_only_when_the_counts_agree():
    from portbench.metrics._share import roofline
    n = _tiny().speech_decoder.llm.num_blocks
    good = {"relpos_causal_attention": n, "relpos_causal_attention_bwd": n}
    share = roofline(_roofline_ctx(good, (n, 5 * n), 1.0),
                     "relpos_causal_attention")
    work = relpos_causal_attention.window(_roofline_ctx(
        good, (0, 0), 0)["shapes"])
    assert share == pytest.approx(100.0 * work["bound_s"] / 2.0)
    # the program ran other calls than the shapes give
    bad = dict(good, relpos_causal_attention_bwd=n + 1)
    assert roofline(_roofline_ctx(bad, (n, 5 * n), 1.0),
                    "relpos_causal_attention") is None
    # the trace holds other operations than the calls launch (4 a backward)
    assert roofline(_roofline_ctx(good, (n, 4 * n), 1.0),
                    "relpos_causal_attention") is None
    # a cell without the part reads nothing
    assert roofline({"shapes": {"cfg": _tiny()}, "trace": {"ops": {}}},
                    "relpos_causal_attention") is None


def test_quantiles_are_one_multiset_per_seed():
    t = {"batch": 16, "duration_s": {"dist": "lognormal", "median": 5.0,
                                     "sigma": 0.4, "min": 2.0, "max": 10.0}}
    a, b = generator.batches(t, 3, 1), generator.batches(t, 3, 2)
    assert all(sorted(x) == sorted(a[0]) for x in a + b)
    assert a != b
    assert statistics.median(a[0]) == pytest.approx(5.0, rel=0.05)
    assert min(a[0]) >= 2.0 and max(a[0]) <= 10.0


def test_arrivals_one_schedule_sizes_reordered():
    t = {"rate_per_s": 10.0, "schedule_seed": 3,
         "duration_s": {"dist": "lognormal", "median": 6, "sigma": 0.6,
                        "min": 1, "max": 20}}
    d1, s1 = generator.arrivals(t, 30, 5)
    d2, s2 = generator.arrivals(t, 30, 2 ** 33 + 1)
    assert len(d1) == len(d2) == 300 and d1[0] == 0.0
    assert all(b >= a for a, b in zip(d1, d1[1:]))
    assert d1 == d2
    gaps = [b - a for a, b in zip(d1, d1[1:])]
    assert sum(gaps) / len(gaps) == pytest.approx(0.1, rel=0.1)
    assert max(gaps) > 5 * min(gaps)
    assert sorted(s1) == sorted(s2) and s1 != s2


def test_open_loop_times_from_the_due_time():
    """One worker, each call 50 ms, three requests due 10 ms apart: the
    later ones wait, and their latency counts the wait from when each was
    due, not from when a worker took it."""
    from portbench.entries import tokenize_serve
    c = tokenize_serve.Cell.__new__(tokenize_serve.Cell)
    c._local = threading.local()
    c.traffic = {"workers": 1}
    c.requests = [{}, {}, {}]
    c.due = [0.0, 0.01, 0.02]

    def slow(_):
        time.sleep(0.05)
        return "ok"
    c._call = slow
    import portbench.entries.tokenize_serve as ts
    kernels = pytest.importorskip("taste_spokenlm_tpu_torch.kernels")
    assert kernels
    stats = c.window(1.0)
    lat = c.latency_ms
    assert stats["failed"] == 0
    assert lat[0] == pytest.approx(50, abs=15)
    assert lat[1] == pytest.approx(90, abs=20)
    assert lat[2] == pytest.approx(130, abs=25)
    assert ts.MISS_MS > 1e6


def test_percentile():
    xs = list(range(1, 101))
    assert common.percentile(xs, 95) == pytest.approx(95.05)
    assert common.percentile([3.0], 95) == 3.0


def test_trace_reading_merges_and_labels():
    class Ev:
        def __init__(self, name, s, e, cuda):
            self._n, self._s, self._e, self._c = name, s, e, cuda

        def name(self):
            return self._n

        def start_ns(self):
            return self._s

        def end_ns(self):
            return self._e

        def is_user_annotation(self):
            return self._n.startswith("pb.")

        def device_type(self):
            from torch.autograd import DeviceType
            return DeviceType.CUDA if self._c else DeviceType.CPU

    class Prof:
        def __exit__(self, *a):
            pass

        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return [Ev("pb.window", 0, 100, False),
                            Ev("pb.window", 0, 100, True),
                            Ev("pb.step", 10, 60, False),
                            Ev("k1", 0, 20, True), Ev("k2", 15, 30, True),
                            Ev("k1", 70, 80, True)]
    out = common.read_trace(Prof())
    assert out["window_s"] == pytest.approx(100e-9)
    assert out["busy_s"] == pytest.approx(40e-9)
    assert out["ops"]["k1"][0] == 2
    assert out["idle_by_span"]["step"] == pytest.approx(40e-9)
    assert out["idle_by_span"]["outside any span"] == pytest.approx(20e-9)
