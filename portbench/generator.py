"""The one traffic generator.  A traffic mix is a JSON file under
`portbench/traffic/`; this module turns its parameters and a seed into
sizes and arrival times.

Every seed gets the same multiset of sizes, in another order, and the
same arrival schedule: sizes are the quantiles of the stated distribution
at (i + 0.5) / n, and gaps the quantiles of the exponential distribution
at the rate, in an order fixed by the traffic file.  So runs with
different seeds do the same amount of work under the same load, and the
seed decides which request or row gets which size.
"""

from __future__ import annotations

import json
import math
import os
import random
from statistics import NormalDist
from typing import Dict, List

TRAFFIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "traffic")


def load_traffic(name: str) -> Dict:
    with open(os.path.join(TRAFFIC_DIR, name + ".json")) as f:
        return json.load(f)


def quantiles(spec: Dict, n: int) -> List[float]:
    """n sizes from `spec` {"dist": "lognormal", "median", "sigma", "min",
    "max"}: the distribution's quantiles at (i + 0.5) / n, clipped."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    unit = NormalDist()
    out = []
    for i in range(n):
        x = spec["median"] * math.exp(spec["sigma"]
                                      * unit.inv_cdf((i + 0.5) / n))
        out.append(min(max(x, spec["min"]), spec["max"]))
    return out


def shuffled(values: List, seed: int, salt: str) -> List:
    """`values` in an order drawn from the seed (and a salt naming the
    use, so two uses of one seed differ)."""
    out = list(values)
    random.Random(f"{seed}:{salt}").shuffle(out)
    return out


def batches(traffic: Dict, n_batches: int, seed: int) -> List[List[float]]:
    """`n_batches` batches of `traffic["batch"]` durations (s), each the
    same multiset of quantiles of `traffic["duration_s"]` in its own
    order."""
    grid = quantiles(traffic["duration_s"], traffic["batch"])
    return [shuffled(grid, seed, f"batch{i}") for i in range(n_batches)]


def arrivals(traffic: Dict, seconds: float, seed: int):
    """An open-loop schedule over `seconds` at `traffic["rate_per_s"]`:
    (due times from the window's start, durations), one request each.
    The gaps are exponential quantiles (a Poisson process's) in the order
    the traffic's `schedule_seed` draws, the same for every seed, so that
    the queue's tail does not change with the seed; the seed orders the
    durations (quantiles of `traffic["duration_s"]`) over them."""
    rate = traffic["rate_per_s"]
    n = max(1, int(round(rate * seconds)))
    gaps = [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
    gaps = shuffled(gaps, traffic["schedule_seed"], "gaps")
    # the first request is due at the window's start
    due, t = [], 0.0
    for g in gaps:
        due.append(t)
        t += g
    durations = shuffled(quantiles(traffic["duration_s"], n), seed,
                         "durations")
    return due, durations


def token_count(duration_s: float, per_s: float, cap: int) -> int:
    return max(1, min(cap, int(round(duration_s * per_s))))
