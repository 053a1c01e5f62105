"""`recon_flow_s` (s): the seconds of the window's calls in the flow's inference, summed
(a harness span, the card synchronized at each call's end)."""


def read(ctx, suffix):
    spans = ctx.get("spans", {}).get("flow")
    return sum(spans) if spans else None
