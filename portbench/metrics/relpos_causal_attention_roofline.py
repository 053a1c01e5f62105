"""`relpos_causal_attention_roofline.<cell kind>` (%): the least time of the window's
`relpos_causal_attention` calls from their shapes (portbench/rooflines/relpos_causal_attention.py) over
their device time in the trace."""

from portbench.metrics._share import roofline


def read(ctx, suffix):
    return roofline(ctx, "relpos_causal_attention")
