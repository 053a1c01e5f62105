"""The train CLI over two gloo processes, killed and resumed (the port's
counterpart of tests/test_multihost.py, at TasteConfig.tiny() on the CPU).

The runs start together when the module starts, each launch with a fresh
coordinator port (a port a SIGKILLed pair held can linger in TIME_WAIT and
stall the next rendezvous, tests/test_multihost.py:30-40):

* a straight pair: `--num-processes 2`, four stage-1 steps;
* a victim pair: the same run to 500 steps, both processes killed with
  SIGKILL once the step-2 checkpoint has landed, then relaunched to four
  steps in the same workdir (it resumes from step 2 and replays the data
  stream);
* a `--model-parallel 2` pair (a (1, 2) mesh: training replicates along
  the model axis) and a one-process run, four steps each.

The relaunched pair's rows 3-4 equal the straight pair's within 1e-6 (as
the one-process drill in tests/test_torch_trainer.py); the model-parallel
pair's rows equal the one-process run's within 1e-6.  The rows are
metrics.jsonl's, which rank 0 writes; the processes run without
TensorBoard (its import pulls in TensorFlow).

Wall on one worker: about 25 s.
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240          # seconds, each process
RESUME_TOL = 1e-6
KEYS = ("loss", "speech_token_accuracy", "commit_loss", "grad_norm")
CLI = ('import sys; sys.modules["torch.utils.tensorboard"] = None; '
       'import runpy; sys.argv[0] = "train"; '
       'runpy.run_module("taste_spokenlm_tpu_torch.scripts.train", '
       'run_name="__main__")')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _args(workdir, steps, *extra):
    return [sys.executable, "-c", CLI, "--tiny", "--synthetic", "--device",
            "cpu", "--stage", "1", "--batch-size", "4", "--log-every", "1",
            "--save-every", "2", "--warmup", "2", "--steps", str(steps),
            "--workdir", str(workdir), *extra]


class Drill:
    def __init__(self, tmp):
        self.tmp = tmp
        self.env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        self.env.pop("WORLD_SIZE", None)
        self.procs, self.logs = {}, {}
        self.closing = False
        self.dirs = {k: tmp / k for k in ("straight", "victim", "mp", "one")}
        self._pair("straight", 4)
        self._pair("mp", 4, "--model-parallel", "2")
        self._start("one", _args(self.dirs["one"], 4))
        self._pair("victim", 500)
        self.killer = threading.Thread(target=self._kill_and_relaunch,
                                       daemon=True)
        self.killer.start()

    def _start(self, name, cmd):
        log = open(self.tmp / f"{name}.log", "w")
        self.logs[name] = self.tmp / f"{name}.log"
        self.procs[name] = subprocess.Popen(cmd, cwd=REPO, env=self.env,
                                            stdout=log,
                                            stderr=subprocess.STDOUT)

    def _pair(self, name, steps, *extra, workdir=None):
        port = f"localhost:{_free_port()}"
        for r in range(2):
            self._start(f"{name}{r}", _args(
                workdir or self.dirs[name], steps, "--coordinator", port,
                "--num-processes", "2", "--process-id", str(r), *extra))

    def _kill_and_relaunch(self):
        victims = [self.procs[f"victim{r}"] for r in range(2)]
        ckpt = self.dirs["victim"] / "ckpt" / "2"
        deadline = time.time() + TIMEOUT
        while not ckpt.exists() and all(p.poll() is None for p in victims) \
                and time.time() < deadline:
            time.sleep(0.05)
        self.killed = all(p.poll() is None for p in victims) and ckpt.exists()
        for p in victims:
            if p.poll() is None:
                os.kill(p.pid, signal.SIGKILL)
            p.wait()
        ckpts = self.dirs["victim"] / "ckpt"
        self.after_kill = sorted(int(p.name) for p in ckpts.iterdir()
                                 if p.name.isdigit()) if ckpts.is_dir() else []
        if not self.closing:
            self._pair("resumed", 4, workdir=self.dirs["victim"])

    def wait(self, *names):
        if any(n.startswith("resumed") for n in names):
            self.killer.join(TIMEOUT)
        for name in names:
            try:
                rc = self.procs[name].wait(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                self.procs[name].kill()
                raise AssertionError(f"{name} ran past {TIMEOUT} s")
            assert rc == 0, self.logs[name].read_text()[-3000:]

    def rows(self, name):
        out = {}
        for line in (self.dirs[name] / "metrics.jsonl").read_text().splitlines():
            row = json.loads(line)
            out[row["step"]] = row
        return out

    def close(self):
        self.closing = True
        for _ in range(2):      # the killer may start "resumed" meanwhile
            for p in list(self.procs.values()):
                if p.poll() is None:
                    p.kill()
                    p.wait()
            self.killer.join(TIMEOUT)


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    d = Drill(tmp_path_factory.mktemp("multihost"))
    yield d
    d.close()


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def test_two_processes_killed_and_resumed_repeat_the_straight_pair(drill):
    drill.wait("straight0", "straight1", "resumed0", "resumed1")
    assert drill.killed, "the victim pair ended before its step-2 checkpoint"
    assert drill.after_kill and drill.after_kill[-1] < 4, drill.after_kill
    assert "resuming from step" in drill.logs["resumed0"].read_text()
    straight, resumed = drill.rows("straight"), drill.rows("victim")
    assert sorted(straight) == [1, 2, 3, 4]
    for s in (3, 4):
        for k in KEYS:
            assert np.isfinite(straight[s][k])
            assert _rel(resumed[s][k], straight[s][k]) <= RESUME_TOL, (s, k)


def test_model_parallel_pair_gives_the_one_process_rows(drill):
    """--model-parallel 2 over two processes is a (1, 2) mesh: both ranks
    take the whole batch and compute the one-process step."""
    drill.wait("mp0", "mp1", "one")
    mp, one = drill.rows("mp"), drill.rows("one")
    assert sorted(mp) == sorted(one) == [1, 2, 3, 4]
    for s in one:
        for k in KEYS:
            assert _rel(mp[s][k], one[s][k]) <= RESUME_TOL, (s, k)
