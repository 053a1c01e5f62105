"""`tokenize_call_ms_p50` (ms): the median of the harness spans around
each `TasteEngine.tokenize` call, from the call to its return (the wait
for the engine's lock included)."""

import statistics


def read(ctx, suffix):
    spans = ctx.get("spans", {}).get("tokenize")
    return 1000.0 * statistics.median(spans) if spans else None
