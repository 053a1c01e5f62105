"""The port's native audio library (taste_spokenlm_tpu_torch/data/native.py
over its copy of csrc/audio_io.cpp) against the JAX package's
data/native.py: the same C++ gives the same samples, bit for bit.

resample / resample_batch at the rates the CLIs and the data pipeline use,
wav_read and py_wav_read on every layout of tests/test_native.py (PCM16 /
24 / 32, float32 and float64, stereo, WAVE_FORMAT_EXTENSIBLE), the error
paths, and the generation CLI's load_audio against JAX's
scripts/generate_audio.load_audio.  One worker: about 10 s (the two g++
builds included).
"""

import importlib.util
import os
import shutil
import struct

import numpy as np
import pytest
import torch

from taste_spokenlm_tpu.data import native as jax_native
from taste_spokenlm_tpu_torch.data import native
from taste_spokenlm_tpu_torch.ops import audio as A

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_raw_wav(path, data_bytes, fmt, channels, sr, bits, ext=False):
    """A RIFF file (the stdlib `wave` writes PCM only); `ext` wraps the
    format in WAVE_FORMAT_EXTENSIBLE."""
    block = channels * bits // 8
    fmt_chunk = struct.pack("<HHIIHH", 0xFFFE if ext else fmt, channels, sr,
                            sr * block, block, bits)
    if ext:
        fmt_chunk += struct.pack("<HHIH", 22, bits, 1 << 2, fmt) + b"\x00" * 14
    body = (b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
            + b"data" + struct.pack("<I", len(data_bytes)) + data_bytes)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)


def _sine(sr=8000, hz=220.0, n=None):
    t = np.arange(n or sr) / sr
    return (0.6 * np.sin(2 * np.pi * hz * t)).astype(np.float32)


def _encode(x, kind):
    if kind == "pcm16":
        return (np.clip(x, -1, 1) * 32767).astype("<i2").tobytes(), 1, 16
    if kind == "pcm24":
        s = (np.clip(x, -1, 1) * 8388607).astype(np.int64)
        b = np.zeros((len(s), 3), np.uint8)
        b[:, 0], b[:, 1], b[:, 2] = s & 0xFF, (s >> 8) & 0xFF, (s >> 16) & 0xFF
        return b.tobytes(), 1, 24
    if kind == "pcm32":
        return (np.clip(x, -1, 1) * 2147483647).astype("<i4").tobytes(), 1, 32
    if kind == "f32":
        return x.astype("<f4").tobytes(), 3, 32
    if kind == "f64":
        return x.astype("<f8").tobytes(), 3, 64
    raise ValueError(kind)


@pytest.mark.parametrize("rates", [(22050, 16000), (44100, 16000),
                                   (16000, 22050), (24000, 16000)])
def test_resample_matches_jax_bit_for_bit(rates):
    x = (np.random.RandomState(0).randn(12345) * 0.3).astype(np.float32)
    got = native.resample(x, *rates)
    np.testing.assert_array_equal(got, jax_native.resample(x, *rates))
    # and the torch resampler's math within float rounding
    ref = A.resample(torch.from_numpy(x)[None], *rates)[0].numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_resample_batch_matches_jax_bit_for_bit():
    r = np.random.RandomState(1)
    sigs = [(r.randn(n) * 0.1).astype(np.float32) for n in (16000, 8000, 12345)]
    got = native.resample_batch(sigs, 16000, 22050, num_threads=3)
    want = jax_native.resample_batch(sigs, 16000, 22050, num_threads=3)
    for g, w, s in zip(got, want, sigs):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, native.resample(s, 16000, 22050))


@pytest.mark.parametrize("kind", ["pcm16", "pcm24", "pcm32", "f32", "f64"])
@pytest.mark.parametrize("layout", ["mono", "stereo", "extensible"])
def test_wav_readers_match_jax(tmp_path, kind, layout):
    sr = 8000
    x = _sine(sr)
    if layout == "stereo":
        data = np.stack([x, 0.5 * x], 1).reshape(-1)
        channels = 2
    else:
        data, channels = x, 1
    raw, fmt, bits = _encode(data, kind)
    path = str(tmp_path / f"{kind}_{layout}.wav")
    _write_raw_wav(path, raw, fmt, channels, sr, bits,
                   ext=layout == "extensible")
    got, got_sr = native.py_wav_read(path)
    want, want_sr = jax_native.py_wav_read(path)
    assert got_sr == want_sr == sr and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    mono = x if layout != "stereo" else 0.75 * x
    np.testing.assert_allclose(got, mono, atol=1e-3)
    if kind != "f64" and layout != "extensible":   # the C++ reader's formats
        got_c, sr_c = native.wav_read(path)
        want_c, _ = jax_native.wav_read(path)
        assert sr_c == sr
        np.testing.assert_array_equal(got_c, want_c)
        np.testing.assert_allclose(got_c, mono, atol=1e-3)


def test_readers_reject_what_jax_rejects(tmp_path):
    with pytest.raises(RuntimeError):
        native.wav_read(str(tmp_path / "missing.wav"))
    path = str(tmp_path / "mp3.wav")
    _write_raw_wav(path, b"\x00" * 64, 85, 1, 8000, 8)
    for reader in (native.py_wav_read, jax_native.py_wav_read):
        with pytest.raises(ValueError, match="arrow shards"):
            reader(path)
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"not a wav file at all")
    with pytest.raises(ValueError, match="RIFF"):
        native.py_wav_read(bad)


def _jax_generate_audio():
    spec = importlib.util.spec_from_file_location(
        "jax_generate_audio", os.path.join(REPO, "scripts", "generate_audio.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_load_audio_matches_jax(tmp_path):
    from taste_spokenlm_tpu_torch.scripts.generate_audio import load_audio
    jax_cli = _jax_generate_audio()
    x = _sine(44100, n=30000)
    for kind in ("pcm16", "pcm24", "pcm32", "f32", "f64"):
        stereo = np.stack([x, -0.25 * x], 1).reshape(-1)
        raw, fmt, bits = _encode(stereo, kind)
        path = str(tmp_path / f"cli_{kind}.wav")
        _write_raw_wav(path, raw, fmt, 2, 44100, bits)
        for sr in (44100, 16000, 24000):
            got = load_audio(path, sr)
            want = jax_cli.load_audio(path, sr)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
        assert abs(len(load_audio(path, 16000)) - len(x) * 16000 / 44100) <= 1
