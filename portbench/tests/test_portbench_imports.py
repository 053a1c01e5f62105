"""Nothing the benchmark loads is JAX or the JAX package, compared by the
top-level name (the part before the first dot) whole, since the port's
name begins with the JAX package's; and the reference loads nothing of
the port."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import common

PKG = common.PKG_DIR
JAX_SIDE = {"jax", "jaxlib", "flax", "taste_spokenlm_tpu"}


def sources(sub=""):
    root = os.path.join(PKG, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_no_jax_in_sources(path):
    assert not set(imported(path)) & JAX_SIDE


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_reference_imports_nothing_of_the_port(path):
    assert "taste_spokenlm_tpu_torch" not in set(imported(path))


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=common.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_loaded_modules():
    """What a run loads (every entry, metric, roofline and the reference)
    holds no JAX-side module; what the reference loads holds no module of
    the port."""
    mods = ["portbench.run", "portbench.control", "portbench.sweep",
            "portbench.flops"]
    for sub in ("entries", "metrics", "rooflines"):
        mods += [f"portbench.{sub}.{f[:-3]}" for f in
                 os.listdir(os.path.join(PKG, sub)) if f.endswith(".py")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import taste_spokenlm_tpu_torch.models.taste\n"
            "import taste_spokenlm_tpu_torch.serving.server\n"
            "import taste_spokenlm_tpu_torch.train.train_step\n"
            "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    assert not _loaded(code) & JAX_SIDE
    ref = [f"portbench.reference.{f[:-3]}" for f in
           os.listdir(os.path.join(PKG, "reference")) if f.endswith(".py")]
    code = ("import importlib, sys\n"
            f"for m in {ref!r}: importlib.import_module(m)\n"
            "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    top = _loaded(code)
    assert "taste_spokenlm_tpu_torch" not in top and not top & JAX_SIDE
