"""Metric logging (counterpart of the JAX utils/metrics.py): a logger whose
lines carry the process's rank, and a writer of scalar rows to
`<logdir>/metrics.jsonl` ({"step", "time", ...}, flushed on every write)
and to TensorBoard when `torch.utils.tensorboard` imports.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict

from taste_spokenlm_tpu_torch.parallel import mesh


def get_logger(name: str = "taste") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            f"%(asctime)s [host{mesh.rank()}] %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


class MetricWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(logdir)
        except Exception:
            pass
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def write(self, step: int, metrics: Dict[str, float]):
        metrics = {k: float(v) for k, v in metrics.items()}
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)
        self._jsonl.write(json.dumps({"step": int(step), "time": time.time(),
                                      **metrics}) + "\n")
        self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()
