"""A cell run as a check of the benchmark runs it, on the card: the command of
BENCHMARK.json from the checkout's root, its last line a result with
`correct` true and every end-to-end metric measured.  Skips without a
CUDA device; run on the card with

    python -m pytest --noconftest portbench/tests/test_portbench_card.py
"""

import json
import subprocess
import sys

import pytest

from portbench import common

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", [w["name"] for w in common.load_json(
    common.BENCHMARK)["workloads"]])
def test_cell_on_the_card(name):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b = common.load_json(common.BENCHMARK)
    cmd = b["command"] + ["--workload", name, "--seed", str(2 ** 31 + 7),
                          "--seconds", "5", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True,
                         cwd=common.ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    spec = common.cell_spec(name)
    for m in spec["end_to_end"]:
        assert isinstance(result["metrics"][m["name"]]["value"], float)
    assert sys.modules.get("jax") is None
