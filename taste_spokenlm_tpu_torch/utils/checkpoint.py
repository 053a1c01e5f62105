"""Checkpoints and resume (counterpart of the JAX utils/checkpoint.py, which
keeps orbax's TrainState: parameters, optimizer state, the RVQ's EMA
collection, the step and the key), on torch.save / torch.load.

A manager's directory holds one directory a saved step:

    <directory>/<step>/state.pt       the saved object (TrainState.state_dict())
    <directory>/<step>/metrics.json   the metrics given to `save`, if any

A step is written under `<step>.tmp` and renamed when complete, so a run
killed mid-save leaves no directory that `latest_step` would pick; opening
the manager removes such leftovers.  The steps kept are those orbax's
CheckpointManagerOptions(max_to_keep, best_fn, best_mode) keeps: without
`best_metric` the latest `max_to_keep`; with it, the `max_to_keep` best by
that metric (ties: the later step) and every step saved without metrics.
A step not past the latest one is not saved (orbax's `should_save`).
Saves are synchronous; `wait` and `close` exist for the JAX manager's
callers.  Under a process group every rank calls `save` and `restore` (the
optimizer's state dict gathers the moments over the data group); one
writer, rank 0, writes the whole state.  The file holds whole parameters
and whole moments, so a step saved on one ("data", "model") mesh restores
on another (data 2 x model 2 and data 2 x model 1 alike).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch

from taste_spokenlm_tpu_torch.parallel import mesh

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"
TMP = ".tmp"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = 5,
                 best_metric: Optional[str] = None, best_mode: str = "min"):
        if best_mode not in ("min", "max"):
            raise ValueError(f"best_mode {best_mode!r} (min | max)")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.best_metric = best_metric
        self.best_mode = best_mode
        if mesh.rank() == 0:
            os.makedirs(self.directory, exist_ok=True)
            for name in os.listdir(self.directory):
                if name.endswith(TMP):
                    shutil.rmtree(os.path.join(self.directory, name))
        mesh.barrier()

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit())

    def metrics(self, step: int) -> Optional[Dict[str, float]]:
        path = os.path.join(self._path(step), METRICS_FILE)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def save(self, step: int, state: Any,
             metrics: Optional[Dict] = None) -> bool:
        """Save `state` (an object with `state_dict()`, or a state dict) as
        `step` -> whether it was saved."""
        latest = self.latest_step()
        mesh.barrier()        # every rank reads it before rank 0 writes
        if latest is not None and latest >= step:
            return False
        tree = state.state_dict() if hasattr(state, "state_dict") else state
        if mesh.rank() == 0:
            tmp = self._path(step) + TMP
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(tree, os.path.join(tmp, STATE_FILE))
            metrics = {k: float(v) for k, v in (metrics or {}).items()}
            if metrics:
                with open(os.path.join(tmp, METRICS_FILE), "w") as f:
                    json.dump(metrics, f)
            os.rename(tmp, self._path(step))
            for old in self._steps_to_remove():
                shutil.rmtree(self._path(old))
        mesh.barrier()
        return True

    def _steps_to_remove(self) -> List[int]:
        """orbax's preservation policy: LatestN without a best metric, else
        BestN with the steps that have no metrics kept."""
        steps = self.all_steps()
        n = self.max_to_keep
        if n is None or len(steps) <= n:
            return []
        if self.best_metric is None or n == 0:
            return steps[:len(steps) - n]
        scored = self._by_metric(steps)
        keep = {s for s, _ in scored[max(len(scored) - n, 0):]}
        keep |= {s for s in steps if self.metrics(s) is None}
        return [s for s in steps if s not in keep]

    def _by_metric(self, steps: List[int]):
        """(step, metrics) of the steps with metrics, worst first, best
        last (a stable sort, as orbax's)."""
        scored = [(s, m) for s, m in ((s, self.metrics(s)) for s in steps)
                  if m is not None]
        return sorted(scored, key=lambda sm: sm[1][self.best_metric],
                      reverse=self.best_mode == "min")

    def restore(self, state: Any = None, step: Optional[int] = None) -> Any:
        """Load `step` (default: the latest) into `state` (an object with
        `load_state_dict`) and return it; with no `state`, return the
        saved state dict."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        tree = torch.load(os.path.join(self._path(step), STATE_FILE),
                          map_location="cpu", weights_only=True)
        if state is None:
            return tree
        state.load_state_dict(tree)
        return state

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        if self.best_metric is None:
            return self.latest_step()
        scored = self._by_metric(self.all_steps())
        return scored[-1][0] if scored else None

    def wait(self):
        mesh.barrier()

    def close(self):
        pass


def save_params(path: str, params: Dict[str, torch.Tensor]) -> None:
    """One-shot save of a state dict to the file `path`, written under a
    temporary name and renamed when complete."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(params, path + TMP)
    os.replace(path + TMP, path)


def load_params(path: str, template: Optional[torch.nn.Module] = None,
                map_location: Any = "cpu") -> Any:
    """The state dict saved at `path`; with a `template` module, loaded into
    it (strict) and the module returned."""
    params = torch.load(os.path.abspath(path), map_location=map_location,
                        weights_only=True)
    if template is None:
        return params
    template.load_state_dict(params, strict=True)
    return template
