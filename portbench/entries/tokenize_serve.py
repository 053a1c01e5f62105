"""The Tokenize RPC as it is served: an open-loop schedule of requests
(Poisson at the traffic's fixed rate) handed to a pool of worker threads
(the gRPC server's `max_workers`), each calling `TasteEngine.tokenize`
(`serving/server.py`) with a whisper log-mel and asr tokens that the
harness made in set-up.  Each request is timed from when it was due, so a
stall also counts against the requests queued behind it; the generator's
own lateness is kept beside.

`correct` holds a sample of the served requests (the one with the most
asr tokens and others drawn from the seed) to the float32 reference
tower: the RVQ's input each request computed and the taste indices it
returned.
"""

from __future__ import annotations

import queue
import random
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import common, generator, inputs, program

MISS_MS = 1e9      # a failed request's latency: past any limit


class Cell:
    def __init__(self, cell: Dict, seed: int, device, traced: bool,
                 tiny: bool = False, seconds: float = 30.0):
        self.cell, self.seed, self.tiny = cell, int(seed), tiny
        self.dev = torch.device(device)
        self.traffic = generator.load_traffic(cell["traffic"])
        if tiny:
            self.traffic.update(self.traffic["tiny"])
        self.seconds = seconds
        self.spans = common.Spans(traced, sync=self.dev.type == "cuda")

    # -- set-up -----------------------------------------------------------

    def setup(self) -> None:
        from taste_spokenlm_tpu_torch.serving.server import TasteEngine
        t = self.traffic
        self.model, self.cfg, self.meta = program.build(
            self.cell["config_file"], self.seed, self.dev, self.tiny)
        self.engine = TasteEngine(self.model, self.cfg,
                                  token_buckets=tuple(t["token_buckets"]))
        self.due, durations = generator.arrivals(t, self.seconds, self.seed)
        w = self.cfg.audio_tower.whisper
        gen = torch.Generator(device=self.dev).manual_seed(self.seed)
        self.requests = []
        for start in range(0, len(durations), 32):
            chunk = durations[start:start + 32]
            wav = inputs.speech_like(chunk, inputs.window_samples(w), gen,
                                     self.dev)
            mels = inputs.whisper_log_mel(wav, w.n_mels).cpu().numpy()
            counts = [generator.token_count(d, t["asr_tokens_per_s"],
                                            t["asr_tokens_max"])
                      for d in chunk]
            ids, _, words = inputs.token_rows(counts, max(counts),
                                              w.vocab_size, gen, self.dev)
            ids, words = ids.cpu().numpy(), words.cpu().numpy()
            for k, n in enumerate(counts):
                self.requests.append({"mel": mels[k], "ids": ids[k, :n],
                                      "words": words[k, :n]})
        self._local = threading.local()
        self.model.audio_tower.vq.rvq.project_in.register_forward_hook(
            lambda m, args, out: setattr(self._local, "z", out))
        self.spans.wrap(self.engine, "tokenize", "tokenize")
        # one call in each token bucket the requests fall in
        seen = set()
        for r in self.requests:
            bucket = self.engine._bucket(len(r["ids"]))
            if bucket not in seen:
                seen.add(bucket)
                self._call(r)

    def _call(self, r):
        return self.engine.tokenize(r["mel"], r["ids"], r["words"])

    # -- the window -------------------------------------------------------

    def window(self, seconds: float) -> Dict:
        from taste_spokenlm_tpu_torch import kernels
        kernels.reset_launch_counts()
        n = len(self.requests)
        self.results: List = [None] * n
        work: "queue.Queue" = queue.Queue()

        def worker():
            while True:
                i = work.get()
                if i is None:
                    return
                try:
                    out = self._call(self.requests[i])
                    self.results[i] = (time.perf_counter(), out,
                                       getattr(self._local, "z", None))
                except Exception as e:  # a failed request is a miss
                    print(f"request {i} failed: {e!r}")
                    self.results[i] = (time.perf_counter(), None, None)

        threads = [threading.Thread(target=worker)
                   for _ in range(self.traffic["workers"])]
        for th in threads:
            th.start()
        t0 = time.perf_counter()
        late = []
        for i, due in enumerate(self.due):
            wait = t0 + due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late.append(time.perf_counter() - (t0 + due))
            work.put(i)
        for _ in threads:
            work.put(None)
        for th in threads:
            th.join(timeout=seconds + 120)
        alive = [th for th in threads if th.is_alive()]
        if alive:
            raise RuntimeError(f"{len(alive)} workers still busy past the "
                               "wait")
        self.launches = kernels.launch_counts()
        lat, failed = [], 0
        for i, res in enumerate(self.results):
            if res is None or res[1] is None:
                failed += 1
                lat.append(MISS_MS)
            else:
                lat.append(1000.0 * (res[0] - (t0 + self.due[i])))
        self.latency_ms = lat
        self.generator_late_ms = 1000.0 * max(late)
        self.window_s = max(r[0] for r in self.results if r) - t0
        return {"attempted": n, "failed": failed,
                "metrics": {"tokenize_p95_ms": common.percentile(lat, 95)}}

    def release(self) -> None:
        del self.engine, self.model
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- per-layer context ------------------------------------------------

    def served(self) -> List[Dict]:
        return [r for r, res in zip(self.requests, self.results)
                if res and res[1] is not None]

    def shapes(self) -> Dict:
        """The window's work by part of the model (portbench/rooflines/):
        each served request's tower forward over one 30-s window."""
        tower_bytes, _ = program.element_bytes(self.cell["config_file"])
        return {"cfg": self.cfg,
                "encoder": [{"rows": 1, "bytes": tower_bytes}
                            for _ in self.served()]}

    def layer_context(self) -> Dict:
        from portbench.flops import ModelFlops
        counter = ModelFlops(program.taste_configs(
            self.cell["config_file"], self.tiny)[1].to_dict())
        return {"spans": self.spans.seconds, "launches": self.launches,
                "model_flops": sum(counter.tower_call(len(r["ids"]))
                                   for r in self.served()),
                "shapes": self.shapes()}

    # -- correct ----------------------------------------------------------

    def verify(self) -> Dict[str, Dict]:
        from portbench.reference import pipeline
        limits = self.cell["workload"]["limits"]
        ref_cfg = pipeline.reference_config(program.taste_configs(
            self.cell["config_file"], self.tiny)[1].to_dict())
        sd = inputs.seeded_state_dict(self.meta, self.seed, self.dev,
                                      prefixes=("audio_tower.",))
        tower = pipeline.build(ref_cfg, sd, parts=("tower",),
                               device=self.dev)["tower"]
        del sd
        served = [i for i, res in enumerate(self.results)
                  if res and res[1] is not None]
        longest = max(served, key=lambda i: len(self.requests[i]["ids"]))
        rest = [i for i in served if i != longest]
        random.Random(f"{self.seed}:sample").shuffle(rest)
        gap = 0.0
        with pipeline.matmul_precision(False):
            for i in [longest] + rest[:self.cell["workload"]["sample"] - 1]:
                r = self.requests[i]

                def dev(x, dtype=torch.long):
                    return torch.as_tensor(np.asarray(x))[None].to(
                        self.dev, dtype)
                n = len(r["ids"])
                gap = max(gap, pipeline.tower_err(
                    tower, dev(r["mel"], torch.float32), dev(r["ids"]),
                    torch.tensor([n], device=self.dev), dev(r["words"]),
                    dev(self.results[i][1]), self.results[i][2][:, :n]))
        return {"tower_err": {"value": gap, "limit": limits["tower_err"]}}
