"""`ffn_int8_roofline.<cell kind>` (%): the least time of the window's
`ffn_int8` calls from their shapes (portbench/rooflines/ffn_int8.py) over
their device time in the trace."""

from portbench.metrics._share import roofline


def read(ctx, suffix):
    return roofline(ctx, "ffn_int8")
