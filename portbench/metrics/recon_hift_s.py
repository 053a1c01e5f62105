"""`recon_hift_s` (s): the seconds of the window's calls in HiFT's forward, summed
(a harness span, the card synchronized at each call's end)."""


def read(ctx, suffix):
    spans = ctx.get("spans", {}).get("hift")
    return sum(spans) if spans else None
