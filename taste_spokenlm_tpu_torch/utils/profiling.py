"""Tracing and per-stage timing (counterpart of the JAX package's
utils/profiling.py): torch.profiler traces, a per-stage wall-time / RTF
report, and the bytes a decode step reads.

    timer = StageTimer()
    with timer.stage("synthesis", sync=model.device):
        out = model.synthesize_from_taste(...)
    timer.report(audio_seconds=n / sr)

A stage with `sync` set to a CUDA device (or a tensor on one) ends in
`torch.cuda.synchronize` on it, so the stage's time is the device's work,
not the host's enqueue.  Each stage is also a `record_function` range, so
it shows in a torch.profiler trace by name.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Mapping, Optional, Union

import torch


@dataclass
class StageTimer:
    """Accumulates wall time per named stage; reports RTF against audio
    seconds."""

    stages: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str,
              sync: Union[None, torch.device, torch.Tensor] = None
              ) -> Iterator[None]:
        dev = sync.device if isinstance(sync, torch.Tensor) else sync
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            yield
            if dev is not None and torch.device(dev).type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
        self.stages[name] = self.stages.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, audio_seconds: Optional[float] = None) -> Dict:
        total = sum(self.stages.values())
        out = {"total_s": round(total, 4),
               "stages": {k: round(v, 4) for k, v in self.stages.items()}}
        if audio_seconds:
            out["audio_s"] = round(audio_seconds, 3)
            out["rtf"] = round(total / audio_seconds, 4)
            out["stage_rtf"] = {k: round(v / audio_seconds, 4)
                                for k, v in self.stages.items()}
        return out

    def dump(self, path: str, audio_seconds: Optional[float] = None):
        with open(path, "w") as f:
            json.dump(self.report(audio_seconds), f, indent=2)


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """A torch.profiler trace of the block (the CPU, and CUDA where there
    is a device), written to <logdir>/trace.json for Perfetto or
    chrome://tracing.  No logdir: no trace."""
    if not logdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# ---------------------------------------------------------------------------
# decode roofline accounting
# ---------------------------------------------------------------------------
#
# The autoregressive decodes are bound by the bytes each step reads, so the
# efficiency to report is bytes read per generated token against the card's
# memory rate:
#
#   steps/s (bound) = bytes/s of the card / bytes_per_step
#   decode_hbm_util = measured steps/s * bytes_per_step / bytes/s of the card
#
# bytes_per_step comes from the serving state dict itself (whatever mix of
# bf16 / int8 / packed int4 it holds), as the JAX package computes it from
# its parameter tree; the counts are equal for the same layout.  Buffers
# that are not parameters of the JAX tree (BatchNorm statistics) are not
# counted.

_NOT_PARAMS = ("running_mean", "running_var", "num_batches_tracked")


def _params(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in state.items() if not k.endswith(_NOT_PARAMS)}


def _sub(state: Mapping[str, torch.Tensor], prefix: str
         ) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


def tree_read_bytes(state: Mapping[str, torch.Tensor]) -> int:
    """Bytes of every tensor of a state dict (one full read)."""
    return int(sum(t.numel() * t.element_size() for t in state.values()))


def _embed_step_bytes(embed: Mapping[str, torch.Tensor]) -> int:
    """A tied head's bytes a step: the input-side gather reads one row
    (negligible), the logits read the whole table: the nibble-packed int4
    copy when there is one, else the int8 copy, else the float table."""
    for keys in (("head_q4", "head_scale4"),
                 ("embedding_q", "embedding_scale")):
        if keys[0] in embed:
            return tree_read_bytes({k: embed[k] for k in keys})
    return tree_read_bytes(embed)


def joint_decode_step_bytes(spoken_lm_state: Mapping[str, torch.Tensor], cfg,
                            ctx_len: int, kv_itemsize: int = 2) -> dict:
    """Bytes read a joint-decode step, from the spoken LM's serving state
    dict (`model.spoken_lm.state_dict()`): the backbone's weights (every
    projection read again each token), the tied head's table, the taste
    bridges, and the KV cache at `ctx_len`."""
    state = _params(spoken_lm_state)
    lm = _sub(state, "language_model.")
    embed = _sub(lm, "embed_tokens.")
    weights = tree_read_bytes({k: v for k, v in lm.items()
                               if not k.startswith("embed_tokens.")})
    bridges = tree_read_bytes({k: v for k, v in state.items()
                               if not k.startswith("language_model.")})
    head = _embed_step_bytes(embed) if embed else 0
    lc = cfg.spoken_lm.llama
    kv = (2 * lc.num_hidden_layers * lc.num_key_value_heads * lc.head_dim
          * ctx_len * kv_itemsize)
    total = weights + bridges + head + kv
    return {"weights": weights, "head": head, "bridges": bridges,
            "kv": kv, "total": total}


# the speech decoder's prefill-only parts: the input-side embeddings read one
# row each and the encoders run once per utterance
_S3_PREFILL = ("audio_token_encoder.", "text_encoder.", "speech_embedding.",
               "llm_embedding.", "text_embedding.", "spk_embed_affine_layer.",
               "audio_embed_affine_layer.", "text_encoder_affine_layer.",
               "audio_token_encoder_affine_layer.",
               "fuse_encoded_audio_text_module.weights")


def s3_decode_step_bytes(speech_decoder_state: Mapping[str, torch.Tensor], cfg,
                         ctx_len: int, kv_itemsize: int = 2) -> dict:
    """Bytes read an S3 decode step, from the speech decoder's serving
    state dict (`model.speech_decoder.state_dict()`): the conformer LM
    stack, the logits head and the KV cache at `ctx_len`."""
    state = _params(speech_decoder_state)
    head = tree_read_bytes(_sub(state, "llm_decoder."))
    rest = {k: v for k, v in state.items()
            if not k.startswith(("llm_decoder.",) + _S3_PREFILL)}
    weights = tree_read_bytes(rest)
    lc = cfg.speech_decoder.llm
    dk = lc.output_size // lc.attention_heads
    kv = 2 * lc.num_blocks * lc.attention_heads * dk * ctx_len * kv_itemsize
    total = weights + head + kv
    return {"weights": weights, "head": head, "kv": kv, "total": total}
