"""The kernels' rooflines.  `portbench/rooflines/<kernel>.py` holds:

- `work(...)`: operations and bytes of one call from its shapes, the least
  work the call needs.  Each input byte is counted once and each output
  byte written once, whatever a kernel reads again; work that depends on
  the data (masked keys) is counted for these inputs.
- `window(shapes)`: {"calls": {wrapper: calls}, "bound_s": seconds} of a
  window's calls from the cell's shape context (each entry's `shapes()`:
  the as-run config and the window's work by part of the model), or None
  where the context holds no part that the kernel runs in.  `calls` is
  keyed by the program's launch counters (`kernels.launch_counts()`).
- `PATTERN`: the kernel's device operations in a profiler trace, and
  `OPS_PER_CALL`: how many of them one call of each wrapper launches.

A new kernel's share is one file here and one reader under
`portbench/metrics/`: the entries expose their shapes once."""

from portbench.common import PEAK_BYTES_PER_S, PEAK_FLOPS


def bound_s(flops: float, n_bytes: float) -> float:
    """The least time on the card: operations over the dense bf16 peak or
    bytes over HBM's, whichever is larger (the same peaks whatever
    precision the kernel computes in)."""
    return max(flops / PEAK_FLOPS, n_bytes / PEAK_BYTES_PER_S)
