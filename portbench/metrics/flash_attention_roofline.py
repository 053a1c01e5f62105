"""`flash_attention_roofline.<cell kind>` (%): the least time of the window's
`flash_attention` calls from their shapes (portbench/rooflines/flash_attention.py) over
their device time in the trace."""

from portbench.metrics._share import roofline


def read(ctx, suffix):
    return roofline(ctx, "flash_attention")
