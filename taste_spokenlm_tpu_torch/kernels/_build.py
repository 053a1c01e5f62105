"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own into
`build/torch_kernels/lib<name>-<hash>.so` at the repository root (a
directory that .gitignore lists), at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/lib<name>-<hash>.so csrc/<name>.cu

The hash covers the source and its headers, so an edited kernel rebuilds.
nvcc's `-Xptxas -v` report (registers, shared memory, spills) is kept
beside each library as `lib<name>-<hash>.so.log`.
Nothing is built or loaded when a module is imported: the CPU tests import
every module and have no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Iterable, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(CSRC))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_ARRIVALS: Dict[Tuple[str, int], object] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _source_hash(name: str) -> str:
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_source_hash(name)}.so")


def _start_build(name: str) -> Tuple[subprocess.Popen, str, str]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = library_path(name)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, proc: subprocess.Popen, tmp: str, out: str
                  ) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    with open(out + ".log", "w") as f:
        f.write(log)
    return log


def build(names: Iterable[str]) -> Dict[str, float]:
    """Build every named kernel that is not built yet, one nvcc process per
    source, all started together.  Returns the seconds each build took
    (0.0 for a library that was already built)."""
    seconds: Dict[str, float] = {}
    started = []
    for name in names:
        if os.path.exists(library_path(name)):
            seconds[name] = 0.0
            continue
        started.append((name, time.perf_counter(), *_start_build(name)))
    errors = []
    for name, t0, proc, tmp, out in started:
        try:
            _finish_build(name, proc, tmp, out)
        except RuntimeError as e:
            errors.append(str(e))
        seconds[name] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str, signatures: Dict[str, Tuple]) -> ctypes.CDLL:
    """Build (if needed) and load lib<name>; `signatures` maps each C
    function to its ctypes argtypes.  Every function returns the int value
    of cudaGetLastError() after its launches."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            from taste_spokenlm_tpu_torch.utils import profiling
            with profiling.span("kernels.load"):
                build([name])
                lib = ctypes.CDLL(library_path(name))
                for fn, argtypes in signatures.items():
                    f = getattr(lib, fn)
                    f.argtypes = list(argtypes)
                    f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


P = ctypes.c_void_p
I = ctypes.c_int
F32 = ctypes.c_float


def ptr(t) -> int:
    return t.data_ptr()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return _sm_count(device.index or 0)


def arrivals(kernel: str, device, n: int):
    """The int32 arrival counters of `kernel` on a CUDA `device`, one buffer
    of `n` a kernel and device, zero between calls: the last block to
    arrive on a tile resets its counter.  Made at the kernel's first call,
    which may not be inside a CUDA graph capture."""
    import torch
    key = (kernel, device.index or 0)
    with _LOCK:
        buf = _ARRIVALS.get(key)
        if buf is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"{kernel}: call it once on this device "
                                   f"before capturing it in a CUDA graph")
            buf = torch.zeros(n, dtype=torch.int32, device=device)
            torch.cuda.synchronize(device)
            _ARRIVALS[key] = buf
        return buf


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
