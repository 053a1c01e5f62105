"""The knee of an open-loop cell, found once when the cell is defined: the
cell's set-up once, then a window at each of several rates, each printed
as one JSON line (rate, requests, completed a second, p50 / p95 / p99 of
the latency from the due time, how late the generator ran, and the last
completion's lag behind the last due time, which grows with the window
when the rate is past what the system sustains).

    python3 -m portbench.sweep --workload tokenize-serve --seed 1 \
        --rates 6,8,10,12,14,16 --seconds 20

The benchmark's runs never run it: a cell offers load at the fixed rate
its traffic file states."""

from __future__ import annotations

import argparse
import importlib
import json
import sys

from portbench import common, generator


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    rates = [float(r) for r in args.rates.split(",")]
    cell = common.cell_spec(args.workload)
    common.float32_as_stated()
    entry = importlib.import_module(
        f"portbench.entries.{cell['workload']['entry']}")
    c = entry.Cell(cell, args.seed, "cuda", traced=False,
                   seconds=args.seconds)
    c.traffic["rate_per_s"] = max(rates)
    c.setup()
    requests = c.requests
    for rate in rates:
        c.traffic["rate_per_s"] = rate
        c.due, _ = generator.arrivals(c.traffic, args.seconds, args.seed)
        c.requests = requests[:len(c.due)]
        stats = c.window(args.seconds)
        done = [r[0] for r in c.results if r and r[1] is not None]
        lat = c.latency_ms
        print(json.dumps({
            "rate_per_s": rate, "requests": len(c.due),
            "failed": stats["failed"],
            "completed_per_s": len(done) / c.window_s,
            "p50_ms": common.percentile(lat, 50),
            "p95_ms": common.percentile(lat, 95),
            "p99_ms": common.percentile(lat, 99),
            "generator_late_ms": c.generator_late_ms,
            "last_lag_s": c.window_s - c.due[-1]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
