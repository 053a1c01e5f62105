"""`fused_dit_block_roofline.<cell kind>` (%): the least time of the window's
`fused_dit_block` calls from their shapes (portbench/rooflines/fused_dit_block.py) over
their device time in the trace."""

from portbench.metrics._share import roofline


def read(ctx, suffix):
    return roofline(ctx, "fused_dit_block")
