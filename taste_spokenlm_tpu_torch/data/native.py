"""ctypes bindings of the native host audio library (csrc/audio_io.cpp),
the port's counterpart of the JAX package's data/native.py.

The library builds with g++ at first use into build/native/ at the
repository root (git-ignored), keyed by a hash of its source, and is
written under a temporary name and renamed into place, so processes that
build it at once never load a half-written file.  `wav_read` decodes
PCM16/24/32 and float32 WAV files (mono mixdown); `resample` and
`resample_batch` are the windowed-sinc resampler of ops/audio.resample
(the same math).  `py_wav_read` is the pure-python reader (float64 WAV
files too), for a host without a C++ compiler.  Callers that want the
torch resampler where the build fails catch OSError / RuntimeError /
subprocess.CalledProcessError.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import List, Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "audio_io.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def _library_path() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libtaste_audio-{digest}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
                        "-pthread", SRC, "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = _library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.resample_out_len.restype = ctypes.c_int64
        lib.resample_out_len.argtypes = [ctypes.c_int64] * 3
        lib.resample.restype = None
        lib.resample.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
        lib.resample_batch.restype = None
        lib.resample_batch.argtypes = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int]
        lib.wav_read.restype = ctypes.c_int
        lib.wav_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)]
        _LIB = lib
        return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resample(x: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Windowed-sinc resampling of a 1-D signal (ops.audio.resample's math)."""
    lib = load()
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim != 1:
        raise ValueError(f"resample takes a 1-D signal, got {x.shape}")
    out = np.empty(lib.resample_out_len(len(x), orig_freq, new_freq),
                   np.float32)
    lib.resample(_fptr(x), len(x), orig_freq, new_freq, _fptr(out))
    return out


def resample_batch(signals: List[np.ndarray], orig_freq: int, new_freq: int,
                   num_threads: int = 0) -> List[np.ndarray]:
    """`resample` of each signal, on `num_threads` threads (0: one a core)."""
    lib = load()
    num_threads = num_threads or (os.cpu_count() or 1)
    sigs = [np.ascontiguousarray(s, np.float32) for s in signals]
    if any(s.ndim != 1 for s in sigs):
        raise ValueError("resample_batch takes 1-D signals")
    outs = [np.empty(lib.resample_out_len(len(s), orig_freq, new_freq),
                     np.float32) for s in sigs]
    n = len(sigs)
    in_ptrs = (ctypes.POINTER(ctypes.c_float) * n)(*[_fptr(s) for s in sigs])
    out_ptrs = (ctypes.POINTER(ctypes.c_float) * n)(*[_fptr(o) for o in outs])
    lens = (ctypes.c_int64 * n)(*[len(s) for s in sigs])
    lib.resample_batch(in_ptrs, lens, n, orig_freq, new_freq, out_ptrs,
                       num_threads)
    return outs


def py_wav_read(path: str) -> Tuple[np.ndarray, int]:
    """Pure-python RIFF / WAV reader: PCM16/24/32, IEEE float32/64 (and
    WAVE_FORMAT_EXTENSIBLE wrappers of those), mono mixdown.  mp3 / flac
    are not decoded here: compressed corpora enter through the pre-decoded
    arrow shards (data/dataset.py)."""
    import struct
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = channels = bits = 0
        sr = 0
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            tag, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if tag == b"fmt ":
                blob = f.read(size)
                fmt, channels, sr, _, _, bits = struct.unpack(
                    "<HHIIHH", blob[:16])
                if fmt == 0xFFFE and size >= 40:   # EXTENSIBLE: sub-format
                    fmt = struct.unpack("<H", blob[24:26])[0]
            elif tag == b"data":
                data = f.read(size)
            else:
                f.seek(size + (size & 1), 1)
        if not channels or not sr or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
    if fmt == 3 and bits == 32:
        x = np.frombuffer(data, "<f4").astype(np.float32)
    elif fmt == 3 and bits == 64:
        x = np.frombuffer(data, "<f8").astype(np.float32)
    elif fmt == 1 and bits == 16:
        x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
    elif fmt == 1 and bits == 24:
        raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
        s = (raw[:, 0].astype(np.int32) | (raw[:, 1].astype(np.int32) << 8)
             | (raw[:, 2].astype(np.int32) << 16))
        s = np.where(s & 0x800000, s | ~0xFFFFFF, s)
        x = s.astype(np.float32) / 8388608.0
    elif fmt == 1 and bits == 32:
        x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"{path}: unsupported wav format "
                         f"(fmt={fmt}, bits={bits}); mp3/flac corpora enter "
                         "via the arrow shards (data/dataset.py)")
    if channels > 1:
        x = x[: (len(x) // channels) * channels]
        x = x.reshape(-1, channels).mean(axis=1)
    return np.ascontiguousarray(x, np.float32), int(sr)


def wav_read(path: str) -> Tuple[np.ndarray, int]:
    """Decode a WAV file to mono float32 (PCM16/24/32 or float32) with the
    native library -> (samples, sample rate)."""
    lib = load()
    sr = ctypes.c_int32(0)
    n = ctypes.c_int64(0)
    rc = lib.wav_read(path.encode(), None, 0, ctypes.byref(sr), ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"wav_read({path}) failed: {rc}")
    out = np.empty(n.value, np.float32)
    rc = lib.wav_read(path.encode(), _fptr(out), n.value, ctypes.byref(sr),
                      ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"wav_read({path}) failed: {rc}")
    return out, sr.value
