"""The port's training harness on the CPU at TasteConfig.tiny(): the remat
policies, the checkpoint round trip, the Trainer, padded rows, ZeRO-1 and
the train CLI (taste_spokenlm_tpu_torch train/trainer.py,
utils/checkpoint.py, ops/remat.py, parallel/mesh.py, scripts/train.py).

The in-process tests run the tiny model whose weights JAX filled and
`convert.params_to_state_dict` carried over (torch_parity_common).  The CLI
runs as subprocesses, started together when the module starts (one thread
each): an uninterrupted 4-step run; the same run on two gloo processes; a
run killed with SIGKILL once its step-2 checkpoint has landed, then
relaunched; a two-process check of ZeRO-1 against the unsharded update;
and a two-process check of the stage-1 gradients with audio dropout on,
of forwards outside a train step and of ranks fed different batches.
The subprocesses run without TensorBoard, whose import (TensorFlow) takes
tens of seconds: the rows checked are metrics.jsonl's.

Tolerances: the remat policies and the round trip are exact on the CPU
(the same ops in the same order) and held at 1e-6 / bit for bit; the
resumed CLI run at 1e-6 (losses), its step and generator exactly; two
processes against one at 1e-5 relative to each tensor's largest value
(losses, gradients, EMA codebooks, Adam's moments: the sums over the ranks
add in another order), and the parameters at 0.1 of each tensor's largest change
(Adam turns an element's near-zero gradient into a step set by its
rounding: test_torch_training.py's PARAM_TOL).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from taste_spokenlm_tpu_torch.config import TasteConfig
from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM
from taste_spokenlm_tpu_torch.ops.remat import apply_remat, parse_remat
from taste_spokenlm_tpu_torch.scripts.train import _pad_batch
from taste_spokenlm_tpu_torch.train import optim, train_step
from taste_spokenlm_tpu_torch.train.trainer import Trainer, TrainerConfig
from taste_spokenlm_tpu_torch.utils.checkpoint import CheckpointManager

from torch_parity_common import inputs, port_model, rel_err, t, tiny_pair

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_TIMEOUT = 240          # seconds, each subprocess
DP_TOL = 1e-5
PARAM_TOL = 0.1
RESUME_TOL = 1e-6
REMAT_TOL = 1e-6


# ---------------------------------------------------------------------------
# the CLI runs, started with the module
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


NO_TENSORBOARD = 'import sys; sys.modules["torch.utils.tensorboard"] = None'
CLI = (NO_TENSORBOARD + '; import runpy; sys.argv[0] = "train"; '
       'runpy.run_module("taste_spokenlm_tpu_torch.scripts.train", '
       'run_name="__main__")')


def _cli(workdir, steps, *extra):
    return [sys.executable, "-c", CLI, "--tiny", "--synthetic", "--device", "cpu", "--stage", "1",
            "--log-every", "1", "--save-every", "2", "--warmup", "2",
            "--steps", str(steps), "--workdir", str(workdir), *extra]


ZERO_CHECK = r"""
import sys, torch, torch.distributed as dist
from taste_spokenlm_tpu_torch.parallel import mesh
from taste_spokenlm_tpu_torch.train.optim import Optimizer
rank = int(sys.argv[1])
SHAPES = ((6, 4), (3,), (5, 7), (), (8, 2, 3), (3, 8))
def params():
    g = torch.Generator().manual_seed(0)
    return [torch.randn(s, generator=g).requires_grad_() for s in SHAPES]
def grads(r, n):
    g = torch.Generator().manual_seed(1 + r)
    return [[torch.randn(s, generator=g) for s in SHAPES] for _ in range(n)]
def run(feed):
    ps = params()
    opt = Optimizer(ps, 1e-2, weight_decay=0.01, grad_clip=1.0)
    for gs in feed:
        for p, g in zip(ps, gs):
            p.grad = g
        opt.step()
    return ps, opt.state_dict(), opt.axes
# one process, fed the sum of both ranks' gradients
ref, ref_state, ref_axes = run(
    [[a + b for a, b in zip(ga, gb)] for ga, gb in zip(grads(0, 3),
                                                       grads(1, 3))])
assert all(a is None for a in ref_axes), ref_axes
mesh.init_distributed(sys.argv[2], 2, rank)
ps, state, axes = run(grads(rank, 3))
assert axes == [0, None, None, None, 0, 1], axes
assert all(torch.equal(a, b) for a, b in zip(ps, ref)), "params"
for k in ("mu", "nu"):
    assert all(torch.equal(a, b) for a, b in zip(state[k], ref_state[k])), k
dist.destroy_process_group()
print("zero ok")
"""


DP_CHECK = r"""
import dataclasses, sys
import numpy as np, torch, torch.distributed as dist
from taste_spokenlm_tpu_torch.config import TasteConfig
from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM
from taste_spokenlm_tpu_torch.parallel import mesh
from taste_spokenlm_tpu_torch.scripts.train import synthetic_batches
from taste_spokenlm_tpu_torch.train.train_step import BATCH_KEYS
torch.set_num_threads(1)
rank, TOL = int(sys.argv[1]), float(sys.argv[3])
cfg = TasteConfig.tiny()
cfg = dataclasses.replace(cfg, audio_tower=dataclasses.replace(
    cfg.audio_tower, audio_dropout_ratio=0.5))
b = next(synthetic_batches(cfg, 4, 1))
b["speech_token_lengths"] = np.array([12, 9, 12, 7], "i4")
batch = {k: torch.from_numpy(v) for k, v in b.items()}
keep = torch.tensor([True, False, False, True])
def model():
    torch.manual_seed(0)
    return TasteForCausalLM(cfg, device="cpu").train()
def forward(m, rows, keep, train=True):
    return m.forward_speech_autoencoder(
        *(rows[k] for k in BATCH_KEYS), train=train,
        generator=torch.Generator().manual_seed(0),
        draws={"audio_keep": keep})
def grads(m):
    return {n: p.grad for n, p in m.named_parameters() if p.grad is not None}
def err(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
# one process, the global batch
m1 = model()
out1 = forward(m1, batch, keep)
out1["loss"].backward()
g1 = grads(m1)
with torch.no_grad():
    eval1 = forward(model().eval(), batch, keep, train=False)["loss"]
mesh.init_distributed(sys.argv[2], 2, rank)
# two processes: the rank's rows, in a train step's data-parallel context
mine = slice(2 * rank, 2 * rank + 2)
m2 = model()
local = mesh.local_rows(batch)
with mesh.data_parallel():
    out2 = forward(m2, local, keep[mine])
    out2["loss"].backward()
    loss2 = mesh.global_sum(out2["loss"].detach())
g2 = grads(m2)
assert set(g2) == set(g1), set(g1) ^ set(g2)
mesh.all_reduce_grads_(list(g2.values()))
assert err(loss2, out1["loss"].detach()) <= TOL, (loss2, out1["loss"])
# each gradient relative to its largest value, or to a thousandth of the
# model's largest gradient where it is smaller: a key bias, which the
# softmax ignores, has a gradient of rounding alone, ~1e-9 of the largest
floor = 1e-3 * max(g.abs().max() for g in g1.values())
for n, g in g1.items():
    e = ((g2[n] - g).abs().max() / torch.maximum(g.abs().max(), floor)).item()
    assert e <= TOL, (n, e)
for (n, v), v2 in zip(m1.state_dict().items(), m2.state_dict().values()):
    if "_codebook" in n and v.is_floating_point():
        assert err(v2, v) <= TOL, n
print("dropout ok", flush=True)
# forwards outside a train step make no collective call (a rank may run
# them alone); the calls are counted and passed on
real = dist.all_reduce, dist.all_gather
calls = []
def counted(fn):
    def call(*a, **k):
        calls.append(fn.__name__)
        return fn(*a, **k)
    return call
dist.all_reduce, dist.all_gather = map(counted, real)
try:
    with torch.no_grad():
        evaled = forward(model().eval(), batch, keep, train=False)["loss"]
        forward(model(), batch, keep)
    assert not calls, len(calls)
    with mesh.data_parallel(), torch.no_grad():
        forward(model(), local, keep[mine])
    assert calls              # (the check sees a train step's collectives)
finally:
    dist.all_reduce, dist.all_gather = real
assert torch.equal(evaled, eval1), (evaled, eval1)
print("alone ok", flush=True)
# ranks fed batches of different shapes raise on every rank
try:
    mesh.local_rows({"x": torch.zeros(4 + 2 * rank, 3)})
except ValueError as e:
    assert "different shapes" in str(e), e
else:
    raise AssertionError("no error for ranks fed different batches")
split = mesh.local_rows({"x": torch.arange(4)})["x"]
assert split.tolist() == [2 * rank, 2 * rank + 1], split
print("shapes ok", flush=True)
dist.destroy_process_group()
"""


class CliRuns:
    """The subprocesses of the module, started at once."""

    def __init__(self, tmp):
        self.tmp = tmp
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        env.pop("WORLD_SIZE", None)
        self.env = env
        self.dirs = {k: tmp / k for k in ("straight", "dp", "victim")}
        self.procs = {}
        self.logs = {}
        self.closing = False
        self._start("straight", _cli(self.dirs["straight"], 4))
        port = f"localhost:{_free_port()}"
        for r in range(2):
            self._start(f"dp{r}", _cli(
                self.dirs["dp"], 4, "--coordinator", port, "--num-processes",
                "2", "--process-id", str(r)))
        zport = f"localhost:{_free_port()}"
        for r in range(2):
            self._start(f"zero{r}", [sys.executable, "-c", ZERO_CHECK, str(r),
                                     zport])
        dport = f"localhost:{_free_port()}"
        for r in range(2):
            self._start(f"dpcheck{r}", [sys.executable, "-c", DP_CHECK,
                                        str(r), dport, str(DP_TOL)])
        self._start("victim", _cli(self.dirs["victim"], 500))
        self.killer = threading.Thread(target=self._kill_and_relaunch,
                                       daemon=True)
        self.killer.start()

    def _start(self, name, cmd):
        log = open(self.tmp / f"{name}.log", "w")
        self.logs[name] = self.tmp / f"{name}.log"
        self.procs[name] = subprocess.Popen(
            cmd, cwd=REPO, env=self.env, stdout=log,
            stderr=subprocess.STDOUT)

    def _kill_and_relaunch(self):
        victim = self.procs["victim"]
        ckpt = self.dirs["victim"] / "ckpt" / "2"
        deadline = time.time() + CLI_TIMEOUT
        while not ckpt.exists() and victim.poll() is None \
                and time.time() < deadline:
            time.sleep(0.05)
        self.killed = victim.poll() is None and ckpt.exists()
        if victim.poll() is None:
            os.kill(victim.pid, signal.SIGKILL)
        victim.wait()
        ckpts = self.dirs["victim"] / "ckpt"
        self.after_kill = sorted(int(p.name) for p in ckpts.iterdir()
                                 if p.name.isdigit()) if ckpts.is_dir() else []
        if not self.closing:
            self._start("resumed", _cli(self.dirs["victim"], 4))

    def wait(self, *names):
        if "resumed" in names:
            self.killer.join(CLI_TIMEOUT)
        for name in names:
            try:
                rc = self.procs[name].wait(timeout=CLI_TIMEOUT)
            except subprocess.TimeoutExpired:
                self.procs[name].kill()
                raise AssertionError(f"{name} ran past {CLI_TIMEOUT} s")
            assert rc == 0, self.logs[name].read_text()[-3000:]

    def close(self):
        self.closing = True
        for _ in range(2):      # the killer may start "resumed" meanwhile
            for p in list(self.procs.values()):
                if p.poll() is None:
                    p.kill()
                    p.wait()
            self.killer.join(CLI_TIMEOUT)


@pytest.fixture(scope="module", autouse=True)
def cli(tmp_path_factory):
    runs = CliRuns(tmp_path_factory.mktemp("cli"))
    yield runs
    runs.close()


def _rows(workdir):
    """{step: the last metrics row of that step} of a workdir."""
    rows = {}
    for line in (workdir / "metrics.jsonl").read_text().splitlines():
        row = json.loads(line)
        rows[row["step"]] = row
    return rows


def _state(workdir, step):
    return torch.load(workdir / "ckpt" / str(step) / "state.pt",
                      weights_only=True)


def _err(got, ref) -> float:
    return rel_err(got.double().numpy(), ref.double().numpy())


# ---------------------------------------------------------------------------
# in-process: the tiny model on JAX's weights
# ---------------------------------------------------------------------------


def _model(remat=False):
    cfg = TasteConfig.tiny()
    if remat is not False:
        cfg = apply_remat(cfg, remat)
    _, _, variables, _ = tiny_pair()
    return port_model(cfg, variables)


def _batch(seed=5, lengths=(12, 9)):
    cfg = TasteConfig.tiny()
    r = np.random.RandomState(seed)
    b = {k: t(v) for k, v in inputs(cfg).items()}
    b["speech_token_ids"] = t(r.randint(
        0, cfg.speech_decoder.speech_token_size, (2, 12)).astype(np.int64))
    b["speech_token_lengths"] = t(np.array(lengths, np.int64))
    return b


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def test_parse_remat():
    assert [parse_remat(v) for v in ("off", "full", "1", "dots",
                                     "dots_no_batch")] == \
        [False, True, True, "dots", "dots_no_batch"]
    with pytest.raises(ValueError):
        parse_remat("most")


@pytest.mark.parametrize("policy", [True, "dots", "dots_no_batch"])
def test_remat_policy_gradients_match_no_remat(policy):
    """One stage-1 forward and backward (train mode, the RVQ's draws given,
    its EMA buffers restored between runs) under each policy against no
    remat: the loss and every gradient at 1e-6.  The backward's aten
    products show what each policy keeps: full remat recomputes the most
    mm, "dots" recomputes no mm and no bmm, "dots_no_batch" no mm but the
    bmm."""
    batch = _batch()
    draws = {"drop_after": 2,
             "dead_picks": t(np.random.RandomState(1).randint(0, 16, (4, 32)))}
    out = {}
    for rm in (False, policy):
        model = _model(rm).train()
        model.zero_grad()
        o = model.forward_speech_autoencoder(
            *(batch[k] for k in train_step.BATCH_KEYS), train=True,
            draws=draws)
        with _CountOps() as ops:
            o["loss"].backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        out[rm] = (o["loss"].item(), grads, ops.counts)
    loss, grads, ops = out[policy]
    loss0, grads0, ops0 = out[False]
    assert abs(loss - loss0) <= REMAT_TOL * abs(loss0)
    assert set(grads) == set(grads0)
    for n, g in grads.items():
        assert _err(g, grads0[n]) <= REMAT_TOL, n
    if policy is True:
        assert ops["mm"] > ops0["mm"] and ops["bmm"] > ops0["bmm"]
    elif policy == "dots":
        assert ops["mm"] == ops0["mm"] and ops["bmm"] == ops0["bmm"]
    else:
        assert ops["mm"] == ops0["mm"] and ops["bmm"] > ops0["bmm"]


def _stage1(model, lr=1e-3):
    mask = optim.trainable_mask(model, optim.STAGE1_PHASES["rvq"])
    opt = optim.make_optimizer(model, optim.warmup_lr(lr, 2), mask=mask,
                               grad_clip=1.0)
    return train_step.make_stage1_step(model, opt, trainable_mask=mask)


def test_save_restore_step_is_bitwise(tmp_path):
    """Two steps, a save; the third step in memory against the third step
    of a fresh model, optimizer and generator restored from the save:
    parameters, EMA buffers, Adam's moments, step and generator to the
    bit (JAX's test_resume_roundtrip_step_bitwise)."""
    batches = [_batch(s, (12, 9 - s)) for s in range(3)]
    step = _stage1(_model().train())
    for b in batches[:2]:
        step(b)
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.save(2, step.state, metrics={"loss": 1.0})
    assert not mgr.save(2, step.state)
    want = step(batches[2])
    ref = step.state.state_dict()

    fresh = _stage1(_model().train())
    assert not torch.equal(fresh.state.generator.get_state(),
                           step.state.generator.get_state())
    mgr.restore(fresh.state)
    assert fresh.state.step == 2
    got = fresh(batches[2])
    for k in want:
        assert torch.equal(got[k], want[k]), k
    new = fresh.state.state_dict()
    assert new["step"] == ref["step"] == 3
    assert torch.equal(new["generator"], ref["generator"])
    assert new["optimizer"]["count"] == ref["optimizer"]["count"]
    for name, v in ref["model"].items():
        assert torch.equal(new["model"][name], v), name
    for k in ("mu", "nu"):
        for a, b in zip(new["optimizer"][k], ref["optimizer"][k]):
            assert torch.equal(a, b), k


def test_trainer_logs_saves_evaluates_and_resumes(tmp_path, monkeypatch):
    """Four steps: a metrics row each (with lr and steps_per_s), eval rows
    every second step, checkpoints at 2 and 4 with max_to_keep 2; a second
    Trainer on the workdir resumes at 4 and runs the fifth."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    batches = [_batch(s, (12, 9 - s)) for s in range(5)]

    def eval_fn(state, batch):
        with torch.no_grad():
            out = state.model.forward_speech_autoencoder(
                *(batch[k] for k in train_step.BATCH_KEYS))
        return {"loss": out["loss"]}

    cfg = TrainerConfig(total_steps=4, log_every=1, eval_every=2,
                        save_every=2, max_to_keep=2,
                        workdir=str(tmp_path / "w"))
    step = _stage1(_model().train())
    schedule = optim.warmup_lr(1e-3, 2)
    trainer = Trainer(cfg, step, eval_fn=eval_fn, schedule=schedule)
    state = trainer.fit(trainer.maybe_resume(step.state), iter(batches),
                        eval_batches=lambda: batches[:1])
    assert state.step == 4
    assert trainer.ckpt.all_steps() == [2, 4]
    rows = [json.loads(x) for x in
            (tmp_path / "w" / "metrics.jsonl").read_text().splitlines()]
    train_rows = [r for r in rows if "loss" in r]
    assert [r["step"] for r in train_rows] == [1, 2, 3, 4]
    for r in train_rows:
        assert {"loss", "commit_loss", "speech_token_accuracy", "grad_norm",
                "lr", "steps_per_s", "time"} <= set(r)
        assert all(np.isfinite(v) for v in r.values())
        assert r["lr"] == pytest.approx(schedule(r["step"] - 1))
    assert [r["step"] for r in rows if "eval/loss" in r] == [2, 4]

    step2 = _stage1(_model().train())
    trainer2 = Trainer(cfg.__class__(**{**cfg.__dict__, "total_steps": 5}),
                       step2, schedule=schedule)
    state2 = trainer2.maybe_resume(step2.state)
    assert state2.step == 4
    trainer2.fit(state2, iter(batches[4:]))
    assert state2.step == 5 and trainer2.ckpt.latest_step() == 4


def test_zero_length_padded_rows_drop_from_loss():
    """The CLI's _pad_batch repeats the last row with zeroed lengths (2 rows
    padded to 4 processes): the loss equals the unpadded batch's (JAX's
    test_zero_length_padded_rows_drop_from_loss)."""
    model = _model()
    b = {k: v.numpy() for k, v in _batch().items()}
    padded = _pad_batch(b, 4)
    assert padded["asr_token_ids"].shape[0] == 4
    assert (padded["speech_token_lengths"][2:] == 0).all()
    assert (padded["asr_token_lengths"][2:] == 0).all()
    np.testing.assert_array_equal(padded["audio_features"][3],
                                  b["audio_features"][1])
    assert _pad_batch(b, 2)["asr_token_ids"].shape[0] == 2

    def loss(batch):
        with torch.no_grad():
            return model.forward_speech_autoencoder(
                *(t(batch[k]) for k in train_step.BATCH_KEYS))["loss"].item()
    assert loss(padded) == pytest.approx(loss(b), rel=1e-5)


# ---------------------------------------------------------------------------
# the CLI subprocesses
# ---------------------------------------------------------------------------


def test_zero1_update_equals_unsharded(cli):
    """Two gloo ranks, each with its own gradients: Adam with its moments
    sharded (each rank updates its slice, then all-gathers) against one
    process's Adam fed the sum of both ranks' gradients, bit for bit, and
    the gathered moments too."""
    cli.wait("zero0", "zero1")
    for r in range(2):
        assert "zero ok" in cli.logs[f"zero{r}"].read_text()


def _dp_check(cli, marker):
    cli.wait("dpcheck0", "dpcheck1")
    for r in range(2):
        assert marker in cli.logs[f"dpcheck{r}"].read_text()


def test_two_processes_audio_dropout_gradients_match_one(cli):
    """Stage 1 with audio dropout (rows 1 and 2 of 4 replaced by noise at
    the batch's std): two gloo processes' loss, gradients summed over the
    ranks and EMA codebooks against one process on the global batch, at
    1e-5.  The noise scale is the global std, and its gradient reaches
    every rank's rows."""
    _dp_check(cli, "dropout ok")


def test_forward_outside_train_step_makes_no_collective_call(cli):
    """Under a group, an eval forward and a train-mode forward outside a
    train step call no collective (a rank may run them alone), and the
    eval loss equals the one-process loss bit for bit; inside
    mesh.data_parallel() the same train forward does call them."""
    _dp_check(cli, "alone ok")


def test_ranks_fed_different_batch_shapes_raise(cli):
    """mesh.local_rows raises on every rank when the ranks' global batches
    differ in shape, and splits a matching one by rank."""
    _dp_check(cli, "shapes ok")


def test_cli_killed_and_resumed_matches_straight_run(cli):
    """SIGKILL once the step-2 checkpoint has landed, relaunch: it resumes
    from step 2 and its steps 3-4 match the uninterrupted run's (losses at
    1e-6; step and generator exactly; every tensor at 1e-6)."""
    cli.wait("straight", "resumed")
    assert cli.killed and cli.after_kill[-1] < 4, cli.after_kill
    log = cli.logs["resumed"].read_text()
    assert "resuming from step 2" in log and log.rstrip().endswith("done")
    straight, resumed = _rows(cli.dirs["straight"]), _rows(cli.dirs["victim"])
    assert sorted(straight) == [1, 2, 3, 4]
    for s in (3, 4):
        for k in ("loss", "commit_loss", "grad_norm"):
            assert rel_err(resumed[s][k], straight[s][k]) <= RESUME_TOL, (s, k)
    a, b = _state(cli.dirs["straight"], 4), _state(cli.dirs["victim"], 4)
    assert a["step"] == b["step"] == 4
    assert torch.equal(a["generator"], b["generator"])
    for name, v in a["model"].items():
        assert _err(b["model"][name], v) <= RESUME_TOL, name
    for k in ("mu", "nu"):
        for x, y in zip(a["optimizer"][k], b["optimizer"][k]):
            assert _err(y, x) <= RESUME_TOL, k


def test_two_gloo_processes_match_one(cli):
    """The same synthetic global batch over two gloo processes (4 rows
    each; the losses' global counts, the RVQ's EMA sums and dead-code picks
    over the global rows, gradients summed before the clip, ZeRO-1 moments)
    against one process."""
    cli.wait("straight", "dp0", "dp1")
    one, two = _rows(cli.dirs["straight"]), _rows(cli.dirs["dp"])
    assert sorted(two) == [1, 2, 3, 4]
    for s in one:
        for k in ("loss", "commit_loss", "speech_token_accuracy",
                  "grad_norm"):
            assert rel_err(two[s][k], one[s][k]) <= DP_TOL, (s, k)
    a, b = _state(cli.dirs["straight"], 4), _state(cli.dirs["dp"], 4)
    assert torch.equal(a["generator"], b["generator"])
    torch.manual_seed(0)             # the CLI's initial weights
    model = TasteForCausalLM(TasteConfig.tiny(), device="cpu")
    start = model.state_dict()
    mask = optim.trainable_mask(model, optim.STAGE1_PHASES["rvq"])
    lr = max(optim.warmup_lr(1.6e-4, 2)(s) for s in range(4))
    key_bias = "self_attn.linear_k.bias"
    for name, v in a["model"].items():
        diff = (b["model"][name].double() - v.double()).abs().max().item()
        if "_codebook" in name:
            assert _err(b["model"][name], v) <= DP_TOL, name
        elif name.endswith(key_bias):
            # a key bias shifts a score row by a constant, which the
            # softmax ignores: its gradient is rounding, which Adam turns
            # into steps of either sign (test_torch_training.py)
            assert diff <= PARAM_TOL * 4 * lr, name
        elif v.is_floating_point():
            change = (v.double() - start[name].double()).abs().max().item()
            assert diff <= PARAM_TOL * change, name
    names = [n for n, _ in model.named_parameters() if mask[n]]
    for k in ("mu", "nu"):
        for name, x, y in zip(names, a["optimizer"][k], b["optimizer"][k]):
            if name.endswith(key_bias):   # moments of rounding, both
                assert max(x.abs().max(), y.abs().max()) <= 1e-8, name
            else:
                assert _err(y, x) <= DP_TOL, (k, name)
