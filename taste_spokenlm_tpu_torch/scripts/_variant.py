"""Build a kernel library from a copy of csrc/ with some of its compile-time
constants replaced, for the sweeps that choose those constants.

    lib = load_variant("relpos_attention", {"FWD_GROUPS": 1}, signatures)

The copy and the library go to build/variants/ (a directory that
.gitignore lists); nvcc takes the port's own flags.  Each constant must
appear in the source once as `constexpr int NAME = <value>;`.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import tempfile
from typing import Dict, Tuple

from taste_spokenlm_tpu_torch.kernels import _build

OUT_DIR = os.path.join(_build.REPO_ROOT, "build", "variants")


def held(name: str, constant: str) -> int:
    """The value csrc/<name>.cu (or a header it includes) holds."""
    for fn in sorted(os.listdir(_build.CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(_build.CSRC, fn)) as f:
                hit = re.search(rf"constexpr int {constant} = (\d+);", f.read())
            if hit:
                return int(hit.group(1))
    raise KeyError(constant)


def load_variant(name: str, values: Dict[str, int],
                 signatures: Dict[str, Tuple]) -> ctypes.CDLL:
    """csrc/<name>.cu built with `values` in place of those constants,
    loaded, each function of `signatures` given its argtypes."""
    os.makedirs(OUT_DIR, exist_ok=True)
    src = tempfile.mkdtemp(dir=OUT_DIR)
    for fn in os.listdir(_build.CSRC):
        path = os.path.join(src, fn)
        shutil.copy(os.path.join(_build.CSRC, fn), path)
        with open(path) as f:
            text = f.read()
        for constant, value in values.items():
            text = re.sub(rf"constexpr int {constant} = \d+;",
                          f"constexpr int {constant} = {value};", text)
        with open(path, "w") as f:
            f.write(text)
    lib = os.path.join(src, f"lib{name}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                    os.path.join(src, f"{name}.cu")], check=True,
                   capture_output=True)
    out = ctypes.CDLL(lib)
    for fn, argtypes in signatures.items():
        getattr(out, fn).argtypes = list(argtypes)
        getattr(out, fn).restype = ctypes.c_int
    return out
