"""The training loop (counterpart of the JAX train/trainer.py): steps,
metric windows, periodic eval and checkpoints.

JAX's steps are pure functions `step(state, batch) -> (state, metrics)`.
The port's steps keep their state inside (train_step.py: `step(batch,
draws=None) -> metrics`, the TrainState in `step.state`), and the Trainer
drives that form: `fit(state, batches)` takes `step.state` to resume from,
save and return, and calls `step_fn(batch)`; `eval_fn(state, batch)` gives
a dict of metrics.

* every `log_every` steps the window's mean of each metric, with `lr`
  (the schedule at the last step) and `steps_per_s`, goes to
  `<workdir>/metrics.jsonl` (and TensorBoard) on rank 0;
* every `eval_every` steps, with an eval function and eval batches, the
  mean eval metrics as `eval/<name>`;
* every `save_every` steps a checkpoint under `<workdir>/ckpt` with
  {"loss"} of that step (best-k by `best_metric`).
Under a data-parallel group every rank runs the same steps and saves;
`eval_fn` runs outside the steps' data-parallel context, so each rank
evaluates the batches it is given.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, Iterator, Optional

from taste_spokenlm_tpu_torch.parallel import mesh
from taste_spokenlm_tpu_torch.train.train_step import TrainState
from taste_spokenlm_tpu_torch.utils.checkpoint import CheckpointManager
from taste_spokenlm_tpu_torch.utils.metrics import MetricWriter, get_logger


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 10000
    log_every: int = 50
    eval_every: int = 1000
    save_every: int = 1000
    max_to_keep: int = 5
    best_metric: Optional[str] = "loss"
    workdir: str = "./workdir"


class Trainer:
    def __init__(self, cfg: TrainerConfig, step_fn: Callable,
                 eval_fn: Optional[Callable] = None,
                 schedule: Optional[Callable] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.eval_fn = eval_fn
        self.schedule = schedule
        self.logger = get_logger()
        self.writer = MetricWriter(cfg.workdir) if mesh.rank() == 0 else None
        self.ckpt = CheckpointManager(f"{cfg.workdir}/ckpt",
                                      max_to_keep=cfg.max_to_keep,
                                      best_metric=cfg.best_metric)

    def maybe_resume(self, state: TrainState) -> TrainState:
        if self.ckpt.latest_step() is not None:
            self.logger.info("resuming from step %s", self.ckpt.latest_step())
            return self.ckpt.restore(state)
        return state

    def fit(self, state: TrainState, batches: Iterator[Dict],
            eval_batches: Optional[Callable[[], Iterable[Dict]]] = None
            ) -> TrainState:
        cfg = self.cfg
        t0 = time.perf_counter()
        window = []
        for step_idx in range(state.step, cfg.total_steps):
            metrics = self.step_fn(next(batches))
            window.append(metrics)

            if (step_idx + 1) % cfg.log_every == 0:
                if self.writer is not None:
                    avg = {k: sum(float(m[k]) for m in window) / len(window)
                           for k in window[0]}
                    if self.schedule is not None:
                        avg["lr"] = float(self.schedule(step_idx))
                    avg["steps_per_s"] = (len(window)
                                          / (time.perf_counter() - t0))
                    self.writer.write(step_idx + 1, avg)
                    self.logger.info("step %d: %s", step_idx + 1,
                                     {k: round(v, 4) for k, v in avg.items()})
                window, t0 = [], time.perf_counter()

            if self.eval_fn and eval_batches and \
                    (step_idx + 1) % cfg.eval_every == 0:
                eval_metrics = self.evaluate(state, eval_batches())
                if self.writer is not None:
                    self.writer.write(
                        step_idx + 1,
                        {f"eval/{k}": v for k, v in eval_metrics.items()})
                    self.logger.info("eval @%d: %s", step_idx + 1,
                                     eval_metrics)

            if (step_idx + 1) % cfg.save_every == 0:
                self.ckpt.save(step_idx + 1, state,
                               metrics={"loss": float(metrics["loss"])})
        self.ckpt.wait()
        return state

    def evaluate(self, state: TrainState, batches: Iterable[Dict]) -> Dict:
        sums: Dict[str, float] = {}
        n = 0
        for batch in batches:
            for k, v in self.eval_fn(state, batch).items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        return {k: round(v / max(n, 1), 5) for k, v in sums.items()}
