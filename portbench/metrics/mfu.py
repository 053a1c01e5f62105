"""`mfu.<cell kind>` (%): the model FLOPs of the window's work, counted
from shapes (portbench/flops.py), over the window times the card's dense
bf16 peak."""

from portbench.common import PEAK_FLOPS


def read(ctx, suffix):
    flops, window = ctx.get("model_flops"), ctx.get("window_s")
    if not flops or not window:
        return None
    return 100.0 * flops / (window * PEAK_FLOPS)
