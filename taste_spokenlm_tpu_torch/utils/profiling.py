"""The port's tracer, per-stage timing (counterpart of the JAX package's
utils/profiling.py) and the bytes a decode step reads.

The tracer records spans and counters where the work happens: the
reconstruction's call tree, each S3 decode step and its read of `done`, the
serving engine's wait for its lock and its service, the train step's
forward, backward and optimizer, and the program's set-up (model
construction, the serving layout, each kernel library's first load).  It
is off until `enable()`.  Off, a span or counter site costs one check of
a module-level flag: no `record_function`, no launch and no host read of a
device value.  On, each span is kept in memory with its name, its start
and end on `time.perf_counter_ns()` (no device synchronize), the thread it
ran on, its parent (the innermost span open on that thread) and a call id
shared by every span of one call or request.  Recording is safe from many
threads.

    profiling.enable()
    out = model.inference_reconstruction(...)
    tree = profiling.spans()          # [Span], in the order they ended
    steps = profiling.counters()["s3.steps"]
    profiling.disable(); profiling.reset()

Spans of the port (name: where):
    reconstruct, tower           models/taste.py inference_reconstruction
    flow, hift                   models/generator.py VoiceGenerator.forward
    s3.prefill                   models/speech_decoder.py generate_stream_init
    s3.step, s3.done_read        models/speech_decoder.py generate_stream_chunk
    engine.prepare, engine.lock_wait, engine.tokenize, engine.reconstruct,
    engine.stream_chunk, engine.complete_batch    serving/server.py
    train.step, train.forward, train.backward, train.optimizer
                                 train/train_step.py (the three steps)
    setup.construct              models/taste.py TasteForCausalLM.__init__
    setup.serving_layout         quant.py serving_state_dict
    kernels.load                 kernels/_build.py load (a library's first)
    StageTimer's stage names     StageTimer.stage
Counters: s3.steps (decode steps run), s3.row_steps (rows x steps run),
s3.row_steps_live (the row-steps before each row stopped).

`StageTimer` accumulates wall time per named stage:

    timer = StageTimer()
    with timer.stage("synthesis", sync=model.device):
        out = model.synthesize_from_taste(...)
    timer.report(audio_seconds=n / sr)

A stage with `sync` set to a CUDA device (or a tensor on one) ends in
`torch.cuda.synchronize` on it, so the stage's time is the device's work,
not the host's enqueue.  Each stage is also a tracer span of its name.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from dataclasses import dataclass, field
from typing import (Dict, Hashable, Iterator, List, Mapping, NamedTuple,
                    Optional, Union)

import torch

# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------


class Span(NamedTuple):
    name: str
    start_ns: int          # time.perf_counter_ns()
    end_ns: int
    thread: int            # threading.get_ident() of the thread
    id: int
    parent: Optional[int]  # id of the innermost span open at the start
    call: Hashable         # shared by the spans of one call or request


_ON = False
_LOCK = threading.Lock()
_SPANS: List[Span] = []
_COUNTERS: Dict[str, int] = {}
_THREADS: Dict[int, int] = {}   # threading.get_ident() -> native id
_IDS = itertools.count()
_OPEN = threading.local()       # .stack: the thread's open spans
_OFF = contextlib.nullcontext()


def enable() -> None:
    global _ON
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


def enabled() -> bool:
    return _ON


def reset() -> None:
    """Forget every recorded span and counter."""
    with _LOCK:
        _SPANS.clear()
        _COUNTERS.clear()


def spans() -> List[Span]:
    """The spans recorded so far, in the order they ended."""
    with _LOCK:
        return list(_SPANS)


def counters() -> Dict[str, int]:
    with _LOCK:
        return dict(_COUNTERS)


def threads() -> Dict[int, int]:
    """{a span's `thread`: that thread's native id} of every thread that
    has opened a span (a profiler may name a thread by either)."""
    with _LOCK:
        return dict(_THREADS)


class _Open:
    __slots__ = ("name", "call", "id", "parent", "start")

    def __init__(self, name: str, call: Hashable):
        self.name, self.call, self.id = name, call, next(_IDS)

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
            with _LOCK:
                _THREADS[threading.get_ident()] = threading.get_native_id()
        up = stack[-1] if stack else None
        self.parent = up.id if up else None
        if self.call is None:
            self.call = up.call if up else self.id
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _OPEN.stack.pop()
        rec = Span(self.name, self.start, end, threading.get_ident(),
                   self.id, self.parent, self.call)
        with _LOCK:
            _SPANS.append(rec)
        return False


def span(name: str, call: Hashable = None):
    """A context manager recording the span `name` while the tracer is on.
    `call` is the call or request id (default: the enclosing span's, or the
    span's own id at the root of a thread)."""
    if not _ON:
        return _OFF
    return _Open(name, call)


def count(name: str, n: int) -> None:
    """Add `n` (a host int) to the counter `name` while the tracer is on."""
    if not _ON:
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + int(n)


# ---------------------------------------------------------------------------
# per-stage timing
# ---------------------------------------------------------------------------


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
        with span(name):
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
