"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the program
(`taste_spokenlm_tpu_torch`) and `BENCHMARK.json`.  Set-up builds the
model and the traffic from the seed and warms the cell's shapes; the
window measures for `--seconds`; then the program is freed and the plain
reference decides `correct`.  `--trace 0` prints the cell's end-to-end
metrics, `--trace 1` its per-layer metrics (a profiler over the window,
spans around the program's calls) with the device's busy and window
seconds and a breakdown.  The numbers compared are printed beside their
limits as the last lines of standard error and under "checks", the last
key of the result line.  Without CUDA, or with fewer cards than the cell
asks for, or without the program, it prints no result and exits 3 or 2;
holding JAX or the JAX package once the window has closed, 4.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _environment(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    libraries kept from loading JAX."""
    cache = os.path.join(root, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, tiny: bool = False) -> dict:
    """Set-up, window and check of one cell -> the result dict.  On the
    CPU (the tests, at TasteConfig.tiny()) every metric is "not measured"."""
    import torch

    from portbench import common
    entry = importlib.import_module(
        f"portbench.entries.{cell['workload']['entry']}")
    on_card = torch.device(device).type == "cuda"
    common.float32_as_stated()
    c = entry.Cell(cell, seed, device, traced=trace and on_card, tiny=tiny,
                   seconds=seconds)
    c.setup()
    setup_s = time.perf_counter() - t_start
    if on_card:
        # the peak of what the window holds, not of set-up's transients
        # (the float weights the served layout is made from)
        for i in range(cell["chips"]):
            torch.cuda.reset_peak_memory_stats(i)
    prof = common.start_trace() if trace and on_card else None
    print(f"setup_s {setup_s:.3f}", file=sys.stderr, flush=True)
    with torch.profiler.record_function("pb.window"):
        stats = c.window(seconds)
    if on_card:
        print(f"window {json.dumps(stats)}", file=sys.stderr, flush=True)
    summary = common.read_trace(prof) if prof is not None else None
    if on_card:
        device_rec = common.device_info(cell["chips"])
    else:
        device_rec = {"platform": "cpu", "kind": "not measured", "count": 0,
                      "memory_peak_bytes": "not measured"}
    if not trace:
        values = dict(stats["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]] if on_card
                               else "not measured", "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    elif on_card:
        ctx = dict(c.layer_context(), trace=summary,
                   window_s=summary["window_s"])
        metrics = common.read_per_layer(cell, ctx)
        device_rec["busy_s"] = summary["busy_s"]
        device_rec["window_s"] = summary["window_s"]
    else:
        metrics = {m["name"]: {"value": "not measured", "unit": m["unit"]}
                   for m in cell["per_layer"]}
    c.release()
    checks = c.verify()
    result = {"correct": common.checks_correct(checks),
              "attempted": stats["attempted"], "failed": stats["failed"],
              "metrics": metrics, "device": device_rec}
    if summary is not None:
        result["breakdown"] = common.breakdown(summary)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = os.getcwd()
    _environment(root)
    try:
        import taste_spokenlm_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not here: {e}", file=sys.stderr)
        return 2
    import torch

    from portbench import common
    cell = common.cell_spec(args.workload,
                            os.path.join(root, "BENCHMARK.json"))
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      T_START)
    bad = common.forbidden_modules()
    if bad:
        print(f"the process holds {bad}", file=sys.stderr)
        return 4
    common.print_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
