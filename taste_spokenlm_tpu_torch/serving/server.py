"""Serving: the engine, the micro-batcher, a load test and the gRPC and
HTTP servers around the composite TASTE model (counterpart of the JAX
serving/server.py).

TasteEngine pads requests to the nearest token bucket, as in JAX, so one
streamer serves every request of a bucket; `complete_batch` decodes up to
16 concurrent requests in one batched joint decode, each row drawing from
its own request seed.  A request's uint64 seed maps to a `torch.Generator`
(`reconstruct`, one a row in `complete_batch`) or to the streams' derived
generators (frontend/streaming.py) in place of JAX's host-built PRNG key.

Concurrency: the engine runs its device work under one lock (a whole
reconstruction, tokenization or batched decode, one chunk of a stream),
and makes no CUDA stream of its own, so every thread's work goes to the
device's default stream in the order the lock admits it (the tracer,
utils/profiling.py, records each wait for the lock as `engine.lock_wait`
and the work under it as `engine.<entry point>`).  The kernels'
launch counters and the arrival counters the gated kernels keep per kind
and device (kernels/_build.py `arrivals`) are therefore never used by two
launches at once.

The gRPC service is wired with generic method handlers; `grpc` and the
protobuf messages (taste_serving_pb2, a copy of the JAX package's) are
imported only by `create_grpc_server`, so this module imports without
them.
"""

from __future__ import annotations

import base64
import concurrent.futures
import contextlib
import itertools
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np
import torch

from taste_spokenlm_tpu_torch.frontend.streaming import (CompletionStreamer,
                                                         StreamingSynthesizer)
from taste_spokenlm_tpu_torch.models.sampler import SamplerConfig
from taste_spokenlm_tpu_torch.utils import profiling

SEED_MASK = 0xFFFFFFFFFFFFFFFF


class TasteEngine:
    """Model wrapper with shape bucketing and one cached streamer per
    bucket and geometry.  `model` is a TasteForCausalLM holding its
    weights, on the device it serves from."""

    BATCH_BUCKETS = (1, 2, 4, 8, 16)

    def __init__(self, model, config, token_buckets=(16, 32, 64)):
        self.model = model
        self.config = config
        self.token_buckets = tuple(sorted(token_buckets))
        self._streamers: Dict[Any, Any] = {}
        self._lock = threading.Lock()
        self._calls = itertools.count()

    @classmethod
    def from_pretrained(cls, checkpoint_dir: str, dtype=None,
                        token_buckets=(16, 32, 64),
                        device=None) -> "TasteEngine":
        """A serving engine over a checkpoint dir of the port
        (pretrained.from_pretrained: the saved dtypes unless `dtype`)."""
        from taste_spokenlm_tpu_torch.pretrained import from_pretrained
        model, _ = from_pretrained(checkpoint_dir, dtype=dtype, device=device)
        return cls(model, model.config, token_buckets=token_buckets)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _bucket(self, n: int) -> int:
        for b in self.token_buckets:
            if n <= b:
                return b
        return self.token_buckets[-1]

    def _generator(self, seed) -> torch.Generator:
        """The request's generator: seeded with the uint64 seed."""
        return torch.Generator(device=self.device).manual_seed(
            int(seed) & SEED_MASK)

    def _pad_tokens(self, ids, word_ids, bucket):
        """-> (ids [1, bucket], lengths [1], word ids [1, bucket]) as int32
        numpy arrays, truncated to the bucket."""
        ids = list(ids)[:bucket]
        word_ids = list(word_ids)[:bucket]
        n = len(ids)
        pad = bucket - n
        ids = np.pad(np.asarray(ids, np.int32), (0, pad))
        word_ids = np.pad(np.asarray(word_ids, np.int32), (0, pad))
        return (ids[None], np.asarray([n], np.int32), word_ids[None])

    def _dev(self, *arrays, dtype=torch.long):
        return tuple(torch.as_tensor(np.asarray(a)).to(self.device, dtype)
                     for a in arrays)

    @contextlib.contextmanager
    def _serving(self, call, what: str):
        """The engine's lock, held for the block: the wait for it is the
        span `engine.lock_wait`, the block the span `engine.<what>`, both
        under the request id `call`."""
        with profiling.span("engine.lock_wait", call):
            self._lock.acquire()
        try:
            with profiling.span("engine." + what, call):
                yield
        finally:
            self._lock.release()

    def _locked(self, it, call):
        """Iterate a stream, each chunk's device work under the lock."""
        done = object()
        while True:
            with self._serving(call, "stream_chunk"):
                out = next(it, done)
            if out is done:
                return
            yield out

    @torch.no_grad()
    def tokenize(self, mel: np.ndarray, asr_ids, asr_word_ids) -> np.ndarray:
        """whisper log-mel [n_mels, frames] + asr tokens -> taste indices
        [n, L] (n = the tokens that fit the bucket)."""
        call = next(self._calls)
        with profiling.span("engine.prepare", call):
            bucket = self._bucket(len(asr_ids))
            ids, lens, words = self._dev(*self._pad_tokens(
                asr_ids, asr_word_ids, bucket))
            (mel_t,) = self._dev(np.asarray(mel, np.float32)[None],
                                 dtype=torch.float32)
        with self._serving(call, "tokenize"):
            out = self.model.audio_tower(mel_t, ids, lens, words)
            return out["quantized_indices"][0, :len(asr_ids)].cpu().numpy()

    @torch.no_grad()
    def reconstruct(self, mel, asr_ids, asr_word_ids, spk, max_steps, seed):
        """-> (wav [n] f32, sample rate, S3 token count, RTF)."""
        call = next(self._calls)
        with profiling.span("engine.prepare", call):
            bucket = self._bucket(len(asr_ids))
            mel_len_max = max(32,
                              int(np.ceil(max_steps / 50 * 22050 / 256)) + 8)
            ids, lens, words = self._dev(*self._pad_tokens(
                asr_ids, asr_word_ids, bucket))
            mel_t, spk_t = self._dev(np.asarray(mel, np.float32)[None],
                                     np.asarray(spk, np.float32)[None],
                                     dtype=torch.float32)
        with self._serving(call, "reconstruct"):
            t0 = time.perf_counter()
            out = self.model.inference_reconstruction(
                spk_t, ids, lens, words, mel_t, max_speech_steps=max_steps,
                mel_len_max=mel_len_max, generator=self._generator(seed))
            wav = out["waveform"][0].float().cpu().numpy()
            n = int(out["waveform_lengths"][0])
            wall = time.perf_counter() - t0
        sr = self.config.hift.sampling_rate
        rtf = wall / max(n / sr, 1e-6)
        return wav[:n], sr, int(out["speech_token_lengths"][0]), rtf

    def synthesize_stream(self, taste_indices, asr_ids, asr_word_ids, spk,
                          max_steps: int = 128, chunk_tokens: int = 50,
                          seed: int = 0):
        """Streaming synthesis: yields (wav_chunk [n] f32, is_last, n_new)
        as each ~chunk_tokens of S3 audio is vocoded.  The taste rows are
        padded to the token bucket (words <= asr tokens); one
        StreamingSynthesizer is cached per bucket and geometry."""
        bucket = self._bucket(len(asr_ids))
        taste = np.asarray(taste_indices, np.int32).reshape(
            -1, self.config.audio_tower.quantizer.num_quantizers)
        n_words = taste.shape[0]
        taste_pad = np.zeros((1, bucket, taste.shape[1]), np.int32)
        taste_pad[0, :min(n_words, bucket)] = np.maximum(taste[:bucket], 0)
        key = ("synthesize_stream", bucket, max_steps, chunk_tokens)
        if key not in self._streamers:
            self._streamers[key] = StreamingSynthesizer(
                self.model, chunk_tokens=chunk_tokens,
                left_ctx_tokens=max(chunk_tokens // 2, 1),
                max_speech_steps=max_steps)
        streamer = self._streamers[key]
        ids, lens, words = self._pad_tokens(asr_ids, asr_word_ids, bucket)
        (spk_t,) = self._dev(np.asarray(spk, np.float32)[None],
                             dtype=torch.float32)
        it = streamer.stream(seed, spk_t, *self._dev(taste_pad, ids, lens,
                                                     words))
        for out in self._locked(it, next(self._calls)):
            yield out["wav"][0], bool(out["is_last"]), int(out["n_new"])

    def _get_tables(self):
        """Sampler tables; without a tokenizer asset, trivial ones."""
        if not hasattr(self, "_tables"):
            v = self.config.spoken_lm.llama.vocab_size
            self._tables = {
                "word_start": torch.from_numpy(np.arange(v) % 3 == 0),
                "banned": torch.zeros((v,), dtype=torch.bool),
                "sentence_end": torch.from_numpy(np.arange(v) % 7 == 0)}
            self._tables = {k: t.to(self.device)
                            for k, t in self._tables.items()}
        return self._tables

    def complete_stream(self, llm_ids, llm_word_ids, llm_indices,
                        asr_ids, asr_word_ids, spk, sampler_kwargs,
                        seed, max_steps: int = 64,
                        max_speech_steps: int = 128, chunk_tokens: int = 50,
                        first_chunk_tokens: int = 16,
                        jd_first_chunk: int = 16):
        """PIPELINED completion: yields (wav_chunk [n] f32, is_last, n_new,
        n_words) with the first chunk after only a partial joint decode.
        `asr_ids` / `asr_word_ids` are the full-budget asr tokenization of
        the completion text (word w of the decode = the asr positions with
        word id w)."""
        bucket = self._bucket(len(llm_ids))
        asr_bucket = self._bucket(len(asr_ids))
        scfg = SamplerConfig(delay=self.config.spoken_lm.delay,
                             **sampler_kwargs)
        fc = min(first_chunk_tokens, chunk_tokens)
        key = ("complete_stream", bucket, asr_bucket, max_steps,
               max_speech_steps, chunk_tokens, fc, jd_first_chunk, scfg)
        if key not in self._streamers:
            self._streamers[key] = CompletionStreamer(
                self.model, scfg, self._get_tables(),
                chunk_tokens=chunk_tokens,
                left_ctx_tokens=max(chunk_tokens // 2, 1),
                first_chunk_tokens=fc, jd_first_chunk=jd_first_chunk,
                jd_chunk=max(jd_first_chunk, 1),
                max_speech_steps=max_speech_steps)
        streamer = self._streamers[key]
        ids, lens, words = self._pad_tokens(llm_ids, llm_word_ids, bucket)
        nq = self.config.audio_tower.quantizer.num_quantizers
        ridx = np.asarray(llm_indices, np.int32).reshape(-1, nq)[:bucket]
        idx = np.full((1, bucket, nq), -1, np.int32)
        idx[0, :len(ridx)] = ridx
        a_ids, _, a_words = self._pad_tokens(asr_ids, asr_word_ids,
                                             asr_bucket)
        (spk_t,) = self._dev(np.asarray(spk, np.float32)[None],
                             dtype=torch.float32)
        it = streamer.stream(
            seed, spk_t, *self._dev(idx, ids, lens, words, a_ids, a_words),
            max_steps=max_steps,
            asr_valid_len=min(len(asr_ids), asr_bucket))
        for out in self._locked(it, next(self._calls)):
            yield (out["wav"][0], bool(out["is_last"]), int(out["n_new"]),
                   int(out["n_words"]))

    def complete(self, llm_ids, llm_word_ids, llm_indices, sampler_kwargs,
                 seed, max_steps: int = 128):
        return self.complete_batch(
            [dict(llm_ids=llm_ids, llm_word_ids=llm_word_ids,
                  llm_indices=llm_indices, seed=seed)],
            sampler_kwargs, max_steps)[0]

    @torch.no_grad()
    def complete_batch(self, requests, sampler_kwargs, max_steps: int = 128):
        """One batched joint text + taste decode over N concurrent requests:
        rows padded to a shared token bucket, the batch to a batch bucket
        (pad rows decode a 1-token prefix), cohorts over the largest batch
        bucket decoded in chunks of it.  Row i draws from a generator
        seeded with ITS OWN request seed, so a sampled request's output does
        not depend on the requests batched with it.

        -> per request {llm_token_ids, llm_word_ids, taste_indices,
        num_tokens, num_taste_words} as numpy, and "ran", the call's record
        shared by its rows: {call, nb, bucket, rows, prefill_rows, steps}
        (prefill_rows = nb x the prefix length)."""
        n_req = len(requests)
        cap = self.BATCH_BUCKETS[-1]
        if n_req > cap:
            out = []
            for i in range(0, n_req, cap):
                out.extend(self.complete_batch(requests[i:i + cap],
                                               sampler_kwargs, max_steps))
            return out
        bucket = self._bucket(max(len(r["llm_ids"]) for r in requests))
        nb = next(b for b in self.BATCH_BUCKETS if n_req <= b)
        delay = self.config.spoken_lm.delay
        scfg = SamplerConfig(delay=delay, **sampler_kwargs)
        nq = self.config.audio_tower.quantizer.num_quantizers
        ids = np.zeros((nb, bucket), np.int32)
        words = np.zeros((nb, bucket), np.int32)
        lens = np.zeros((nb,), np.int32)
        idx = np.full((nb, bucket, nq), -1, np.int32)
        for i, r in enumerate(requests):
            row = list(r["llm_ids"])[:bucket]
            ids[i, :len(row)] = row
            words[i, :len(row)] = list(r["llm_word_ids"])[:bucket]
            lens[i] = len(row)
            ridx = np.asarray(r["llm_indices"], np.int32)[:bucket]
            idx[i, :len(ridx)] = ridx
        lens = np.maximum(lens, 1)  # pad rows decode a dummy 1-token prefix
        gens = ([self._generator(r.get("seed", 0)) for r in requests]
                + [self._generator(0) for _ in range(nb - n_req)])
        tables = self._get_tables()
        call = next(self._calls)
        with self._serving(call, "complete_batch"):
            out = self.model.generate_completion(
                scfg, tables, *self._dev(idx, ids, lens, words), "audio",
                max_steps, generator=gens)
            steps = int(out.pop("steps"))
            out = {k: v.cpu().numpy().astype(np.int32)
                   for k, v in out.items()}
        ran = {"call": call, "nb": nb, "bucket": bucket,
               "rows": n_req, "prefill_rows": nb * (1 + bucket + delay),
               "steps": steps}
        return [dict({k: val[i] for k, val in out.items()}, ran=ran)
                for i in range(n_req)]


class CompleteBatcher:
    """Micro-batching front of `TasteEngine.complete_batch`: concurrent
    Complete requests that share a sampling config and max_steps are
    gathered for up to `window_ms` (or until `max_batch`) and decoded in
    ONE batched call.  `close` stops its thread."""

    def __init__(self, engine: TasteEngine, max_batch: int = 4,
                 window_ms: float = 5.0):
        self.engine = engine
        self.max_batch = max_batch
        self.window = window_ms / 1e3
        self._cv = threading.Condition()
        self._queue: list = []   # (group_key, request_dict, future)
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def close(self, timeout: float = 5.0):
        """Stop the micro-batch loop once the queue is drained."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout)

    def submit(self, llm_ids, llm_word_ids, llm_indices, sampler_kwargs,
               seed, max_steps: int = 128) -> "concurrent.futures.Future":
        fut: concurrent.futures.Future = concurrent.futures.Future()
        gk = (tuple(sorted(sampler_kwargs.items())), max_steps)
        req = dict(llm_ids=llm_ids, llm_word_ids=llm_word_ids,
                   llm_indices=llm_indices, seed=seed)
        with self._cv:
            self._queue.append((gk, req, fut))
            self._cv.notify()
        return fut

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue and not self._stopped:
                    self._cv.wait()
                if self._stopped and not self._queue:
                    return
                deadline = time.perf_counter() + self.window
                while len(self._queue) < self.max_batch:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                gk = self._queue[0][0]
                batch = [q for q in self._queue if q[0] == gk][:self.max_batch]
                for q in batch:
                    self._queue.remove(q)
            try:
                results = self.engine.complete_batch(
                    [q[1] for q in batch], dict(gk[0]), gk[1])
            except Exception as e:  # each caller's future raises it
                for _, _, fut in batch:
                    fut.set_exception(e)
                continue
            for (_, _, fut), res in zip(batch, results):
                fut.set_result(res)


def run_load_test(engine: TasteEngine, requests, sampler_kwargs,
                  max_steps: int = 8, max_batch: int = 8,
                  window_ms: float = 5.0) -> Dict[str, Any]:
    """Submit ALL `requests` to a micro-batcher at once (one thread each)
    and report latency percentiles and the aggregate decode throughput:
    {"n", "p50_ms", "p99_ms", "max_ms", "wall_s", "total_tokens",
    "tokens_per_sec", "results"} ("results": each request's
    complete_batch row, in order).  Run it once first to warm up."""
    n = len(requests)
    batcher = CompleteBatcher(
        engine, max_batch=min(max_batch, TasteEngine.BATCH_BUCKETS[-1]),
        window_ms=window_ms)
    lat = [0.0] * n
    results: list = [None] * n

    def fire(i):
        r = requests[i]
        t0 = time.perf_counter()
        results[i] = batcher.submit(
            r["llm_ids"], r["llm_word_ids"], r["llm_indices"],
            sampler_kwargs, r.get("seed", 0), max_steps).result()
        lat[i] = time.perf_counter() - t0

    try:
        t_all = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(n) as ex:
            list(ex.map(fire, range(n)))
        wall = time.perf_counter() - t_all
    finally:
        batcher.close()
    total_tokens = sum(int(r["num_tokens"]) for r in results)
    lat_ms = sorted(x * 1e3 for x in lat)
    return {
        "n": n,
        "p50_ms": lat_ms[n // 2],
        "p99_ms": lat_ms[min(n - 1, int(np.ceil(0.99 * n)) - 1)],
        "max_ms": lat_ms[-1],
        "wall_s": wall,
        "total_tokens": total_tokens,
        "tokens_per_sec": total_tokens / max(wall, 1e-9),
        "results": results,
    }


def _pcm16(wav: np.ndarray) -> bytes:
    return (np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes()


# ---------------------------------------------------------------------------
# gRPC (generic handlers: no grpc_tools code generation needed)
# ---------------------------------------------------------------------------


def create_grpc_server(engine: TasteEngine, port: int = 50051,
                       max_workers: int = 4,
                       batcher: Optional[CompleteBatcher] = None):
    """-> (grpc server, bound port) serving taste_serving.Taste: Tokenize,
    Reconstruct, Complete (through `batcher`, by default one of
    max_workers rows), Synthesize and CompleteStream (server-streaming)."""
    import grpc

    from taste_spokenlm_tpu_torch.serving import taste_serving_pb2 as pb
    if batcher is None:
        batcher = CompleteBatcher(
            engine,
            max_batch=min(max_workers, TasteEngine.BATCH_BUCKETS[-1]))

    def sampler_kwargs(c):
        return dict(extra_words=c.extra_words or 8, text_top_p=c.text_top_p,
                    taste_top_p=c.taste_top_p,
                    text_temperature=c.temperature or 1.0,
                    repetition_penalty=c.repetition_penalty or 1.0)

    def Tokenize(request, context):
        mel = np.asarray(request.audio_features, np.float32).reshape(
            request.n_mels, request.n_frames)
        idx = engine.tokenize(mel, list(request.asr_token_ids),
                              list(request.asr_word_ids))
        return pb.TokenizeResponse(indices=idx.reshape(-1).tolist(),
                                   n_quantizers=idx.shape[-1])

    def Reconstruct(request, context):
        inp = request.inputs
        mel = np.asarray(inp.audio_features, np.float32).reshape(
            inp.n_mels, inp.n_frames)
        wav, sr, n_tokens, rtf = engine.reconstruct(
            mel, list(inp.asr_token_ids), list(inp.asr_word_ids),
            np.asarray(request.speaker_embedding, np.float32),
            request.max_speech_steps or 64, request.seed)
        return pb.ReconstructResponse(pcm16=_pcm16(wav), sample_rate=sr,
                                      num_speech_tokens=n_tokens, rtf=rtf)

    def Complete(request, context):
        nq = engine.config.audio_tower.quantizer.num_quantizers
        idx = np.asarray(request.llm_indices, np.int32).reshape(-1, nq)
        out = batcher.submit(
            list(request.llm_token_ids), list(request.llm_word_ids), idx,
            sampler_kwargs(request), request.seed).result()
        n = int(out["num_tokens"])
        nt = int(out["num_taste_words"])
        return pb.CompleteResponse(
            token_ids=out["llm_token_ids"][:n].tolist(),
            word_ids=out["llm_word_ids"][:n].tolist(),
            taste_indices=out["taste_indices"][:nt].reshape(-1).tolist(),
            num_taste_words=nt)

    def Synthesize(request, context):
        """PCM chunks as the chunked decode and the windowed vocoder make
        them."""
        sr = engine.config.hift.sampling_rate
        for wav, is_last, n_new in engine.synthesize_stream(
                list(request.taste_indices), list(request.asr_token_ids),
                list(request.asr_word_ids),
                np.asarray(request.speaker_embedding, np.float32),
                max_steps=request.max_speech_steps or 128,
                chunk_tokens=request.chunk_tokens or 50,
                seed=request.seed):
            yield pb.SynthesizeChunk(pcm16=_pcm16(wav), sample_rate=sr,
                                     is_last=is_last, num_tokens=n_new)

    def CompleteStream(request, context):
        """The pipelined completion: the first PCM chunk leaves after a
        partial joint decode."""
        c = request.complete
        nq = engine.config.audio_tower.quantizer.num_quantizers
        idx = np.asarray(c.llm_indices, np.int32).reshape(-1, nq)
        sr = engine.config.hift.sampling_rate
        for wav, is_last, n_new, n_words in engine.complete_stream(
                list(c.llm_token_ids), list(c.llm_word_ids), idx,
                list(request.asr_token_ids), list(request.asr_word_ids),
                np.asarray(request.speaker_embedding, np.float32),
                sampler_kwargs(c), c.seed,
                max_steps=request.max_steps or 64,
                max_speech_steps=request.max_speech_steps or 128,
                chunk_tokens=request.chunk_tokens or 50,
                first_chunk_tokens=request.first_chunk_tokens or 16,
                jd_first_chunk=request.jd_first_chunk or 16):
            yield pb.SynthesizeChunk(pcm16=_pcm16(wav), sample_rate=sr,
                                     is_last=is_last, num_tokens=n_new,
                                     n_words=n_words)

    handlers = {
        "CompleteStream": grpc.unary_stream_rpc_method_handler(
            CompleteStream,
            request_deserializer=pb.CompleteStreamRequest.FromString,
            response_serializer=pb.SynthesizeChunk.SerializeToString),
        "Synthesize": grpc.unary_stream_rpc_method_handler(
            Synthesize, request_deserializer=pb.SynthesizeRequest.FromString,
            response_serializer=pb.SynthesizeChunk.SerializeToString),
        "Tokenize": grpc.unary_unary_rpc_method_handler(
            Tokenize, request_deserializer=pb.TokenizeRequest.FromString,
            response_serializer=pb.TokenizeResponse.SerializeToString),
        "Reconstruct": grpc.unary_unary_rpc_method_handler(
            Reconstruct, request_deserializer=pb.ReconstructRequest.FromString,
            response_serializer=pb.ReconstructResponse.SerializeToString),
        "Complete": grpc.unary_unary_rpc_method_handler(
            Complete, request_deserializer=pb.CompleteRequest.FromString,
            response_serializer=pb.CompleteResponse.SerializeToString),
    }
    server = grpc.server(
        concurrent.futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        "taste_serving.Taste", handlers),))
    bound = server.add_insecure_port(f"[::]:{port}")
    return server, bound


# ---------------------------------------------------------------------------
# HTTP (standard library only)
# ---------------------------------------------------------------------------


def create_http_server(engine: TasteEngine, port: int = 8080,
                       host: str = "0.0.0.0"):
    """A ThreadingHTTPServer: GET /health, POST /tokenize and /reconstruct
    (JSON); 404 for any other route, 500 with the error's text when a
    request fails.  The caller runs serve_forever and shutdown."""
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _json(self, code: int, payload: Dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok"})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                if self.path == "/tokenize":
                    mel = np.asarray(req["audio_features"], np.float32)
                    idx = engine.tokenize(mel, req["asr_token_ids"],
                                          req["asr_word_ids"])
                    self._json(200, {"indices": idx.tolist()})
                elif self.path == "/reconstruct":
                    mel = np.asarray(req["audio_features"], np.float32)
                    wav, sr, n_tok, rtf = engine.reconstruct(
                        mel, req["asr_token_ids"], req["asr_word_ids"],
                        np.asarray(req["speaker_embedding"], np.float32),
                        req.get("max_speech_steps", 64), req.get("seed", 0))
                    self._json(200, {
                        "pcm16_b64": base64.b64encode(_pcm16(wav)).decode(),
                        "sample_rate": sr, "num_speech_tokens": n_tok,
                        "rtf": rtf})
                else:
                    self._json(404, {"error": "not found"})
            except Exception as e:  # the request's failure, to its client
                self._json(500, {"error": str(e)})

    return ThreadingHTTPServer((host, port), Handler)
