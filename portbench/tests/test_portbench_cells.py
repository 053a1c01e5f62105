"""Each cell kind end to end on the CPU at TasteConfig.tiny() (the
kernels' plain versions): set-up, a short window, the check against the
reference, every device metric "not measured".  Then the same runs with
the timed path broken underneath, which `correct` must catch, and the
controls, which must run and read worse than the program."""

import time

import pytest
import torch

from portbench import common, control
from portbench.run import run_cell

CELLS = [w["name"] for w in common.load_json(common.BENCHMARK)["workloads"]]


def run(name, seed=2 ** 33 + 5, trace=False):
    cell = common.cell_spec(name)
    return run_cell(cell, seed, 0.05, trace, "cpu", time.perf_counter(),
                    tiny=True)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_on_the_cpu(name, trace):
    r = run(name, trace=trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert all(m["value"] == "not measured" for m in r["metrics"].values())
    assert r["device"]["kind"] == "not measured"
    assert list(r)[-1] == "checks"
    spec = common.cell_spec(name)
    want = spec["per_layer"] if trace else spec["end_to_end"]
    assert set(r["metrics"]) == {m["name"] for m in want}


def _fails(r, check):
    assert not r["correct"]
    assert r["checks"][check]["value"] > r["checks"][check]["limit"]


def test_recon_altered_token_fails(monkeypatch):
    from taste_spokenlm_tpu_torch.models.speech_decoder import \
        TasteSpeechDecoder
    inner = TasteSpeechDecoder.generate

    def altered(self, *a, **k):
        out = inner(self, *a, **k)
        ids = out["speech_token_ids"]
        ids[:, 0] = torch.where(ids[:, 0] >= 0, (ids[:, 0] + 1)
                                % self.config.speech_token_size, ids[:, 0])
        return out
    monkeypatch.setattr(TasteSpeechDecoder, "generate", altered)
    _fails(run("recon-batch"), "s3_logit_gap")


def test_recon_altered_taste_index_fails(monkeypatch):
    from taste_spokenlm_tpu_torch.models.audio_tower import TasteAudioTower
    inner = TasteAudioTower.forward

    def altered(self, *a, **k):
        out = inner(self, *a, **k)
        idx = out["quantized_indices"]
        idx[:, 0, 0] = (idx[:, 0, 0] + 1) % self.config.quantizer.codebook_size
        return out
    monkeypatch.setattr(TasteAudioTower, "forward", altered)
    _fails(run("recon-batch"), "tower_err")
    _fails(run("tokenize-serve"), "tower_err")


def test_recon_altered_mel_and_wave_fail(monkeypatch):
    from taste_spokenlm_tpu_torch.models.flow import MaskedDiffWithXvec
    from taste_spokenlm_tpu_torch.models.hift import HiFTGenerator
    flow, hift = MaskedDiffWithXvec.inference, HiFTGenerator.forward

    def mel(self, *a, **k):
        m, n = flow(self, *a, **k)
        return m * 1.5, n

    def wav(self, *a, **k):
        return hift(self, *a, **k) * 1.5
    monkeypatch.setattr(MaskedDiffWithXvec, "inference", mel)
    monkeypatch.setattr(HiFTGenerator, "forward", wav)
    r = run("recon-batch")
    _fails(r, "flow_mel_err")
    _fails(r, "hift_wav_err")


def test_stage1_unchanged_state_fails(monkeypatch):
    from taste_spokenlm_tpu_torch.train import optim

    def no_update(self):
        return optim.global_norm([p.grad for p in self.params
                                  if p.grad is not None])
    monkeypatch.setattr(optim.Optimizer, "step", no_update)
    _fails(run("stage1-train"), "change_leaf_gap")


def test_stage1_half_batch_fails(monkeypatch):
    from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM
    inner = TasteForCausalLM.forward_speech_autoencoder

    def half(self, *a, **k):
        b = a[0].shape[0] // 2
        draws = dict(k["draws"], dead_picks=k["draws"]["dead_picks"]
                     % (b * a[1].shape[1]))
        return inner(self, *(x[:b] for x in a), **dict(k, draws=draws))
    monkeypatch.setattr(TasteForCausalLM, "forward_speech_autoencoder", half)
    _fails(run("stage1-train"), "first_grad_leaf_gap")


@pytest.mark.parametrize("name", CELLS)
def test_control_runs(name):
    import importlib
    cell = common.cell_spec(name)
    entry = importlib.import_module(
        f"portbench.entries.{cell['workload']['entry']}")
    c = entry.Cell(cell, 5, "cpu", traced=False, tiny=True, seconds=0.05)
    c.setup()
    c.window(0.05)
    c.release()
    prog = {k: v["value"] for k, v in c.verify().items()}
    ctl = control.CONTROLS[cell["workload"]["entry"]](c)
    readings = ctl.get("control", ctl)
    assert set(readings) == set(prog)
    assert all(v == v and v >= 0 for v in readings.values())
    if name != "tokenize-serve":      # TF32 does nothing on the CPU
        assert any(readings[k] > prog[k] for k in prog), (readings, prog)
