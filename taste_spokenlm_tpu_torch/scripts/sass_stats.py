"""Registers and SASS of the kernels in CUDA sources, as nvcc builds them
for the H100 (kernels/_build.py's flags, into a cubin) and cuobjdump reads
them.  For every kernel whose name holds `--match`, one JSON line a source:
its registers, its instruction count, two hashes (one of the whole
instruction text, one of the opcodes alone) and the count of each opcode.
Two sources built from the same code give the same hashes; where only the
parameter offsets moved, the opcode hash stays and the text hash does not.

Usage (needs the CUDA toolkit): python -m
taste_spokenlm_tpu_torch.scripts.sass_stats A.cu [B.cu ...] [--match NAME]
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import re
import subprocess
import tempfile

from taste_spokenlm_tpu_torch.kernels import _build

_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);")
_FUNC = re.compile(r"Function : (\S+)")
_REGS = re.compile(r"Function (\S+):\s+REG:(\d+)")


def _cuobjdump(*args: str) -> str:
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([tool, *args], capture_output=True, text=True,
                          check=True).stdout


def kernels(source: str):
    """{kernel: (registers, [instruction text])} of one source's cubin."""
    flags = list(_build.NVCC_FLAGS)          # less -shared -Xcompiler -fPIC
    flags.remove("-shared")
    at = flags.index("-Xcompiler")
    del flags[at:at + 2]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        subprocess.run([_build._nvcc(), *flags, "-cubin", "-o", cubin,
                        source], check=True, capture_output=True, text=True)
        regs = dict(_REGS.findall(_cuobjdump("-res-usage", cubin)))
        found, name = {}, None
        for line in _cuobjdump("-sass", cubin).splitlines():
            head = _FUNC.search(line)
            if head:
                name = head.group(1)
                found[name] = (int(regs.get(name, -1)), [])
            elif name and (insn := _INSN.search(line)):
                found[name][1].append(" ".join(insn.group(1).split()))
    return found


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--match", default="")
    args = ap.parse_args()
    for source in args.sources:
        for name, (regs, insns) in sorted(kernels(source).items()):
            if args.match not in name:
                continue
            ops = [i.split()[0] if not i.startswith("@") else i.split()[1]
                   for i in insns]
            print(json.dumps({
                "source": source, "kernel": name, "registers": regs,
                "instructions": len(insns),
                "text_sha1": hashlib.sha1("\n".join(insns).encode()
                                          ).hexdigest()[:12],
                "opcode_sha1": hashlib.sha1(" ".join(ops).encode()
                                            ).hexdigest()[:12],
                "opcodes": dict(sorted(collections.Counter(ops).items()))}),
                  flush=True)


if __name__ == "__main__":
    main()
