"""A kernel's share of its roofline over a traced window."""

import importlib
import sys

from portbench.common import kernel_device_time


def roofline(ctx, kernel: str):
    """100 x (the least time the window's calls of `kernel` need, from
    the cell's shapes: portbench/rooflines/<kernel>.py) / (that kernel's
    device time in the trace).  None, with the reason on standard error,
    unless the calls from the shapes are what the program counted and
    their operations what the trace holds: a share over work that was
    counted wrong would read wrong."""
    trace, shapes = ctx.get("trace"), ctx.get("shapes")
    if trace is None or not shapes:
        return None
    rl = importlib.import_module(f"portbench.rooflines.{kernel}")
    work = rl.window(shapes)
    if work is None or not any(work["calls"].values()):
        return None
    secs, ops = kernel_device_time(trace, rl.PATTERN)
    launches = ctx.get("launches") or {}
    counted = {w: launches.get(w, 0) for w in work["calls"]}
    want_ops = sum(n * rl.OPS_PER_CALL[w] for w, n in work["calls"].items())
    print(f"{kernel}: calls from the shapes {work['calls']}, counted by the "
          f"program {counted}, {ops} device operations traced (expected "
          f"{want_ops}) in {secs:.6f} s", file=sys.stderr)
    if counted != work["calls"]:
        print(f"{kernel}: left out: the program counted other calls than "
              "the shapes give", file=sys.stderr)
        return None
    if ops != want_ops:
        print(f"{kernel}: left out: the trace holds other operations than "
              "the calls launch", file=sys.stderr)
        return None
    if secs <= 0.0:
        return None
    return 100.0 * work["bound_s"] / secs
