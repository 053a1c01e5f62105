"""`recon_tower_s` (s): the seconds of the window's calls in the audio tower's forward, summed
(a harness span, the card synchronized at each call's end)."""


def read(ctx, suffix):
    spans = ctx.get("spans", {}).get("audio_tower")
    return sum(spans) if spans else None
