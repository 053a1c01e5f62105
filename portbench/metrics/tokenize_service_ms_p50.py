"""`tokenize_service_ms_p50` (ms): the median of the window's Tokenize
services, from the engine's lock held to the indices on the host (the
program's span `engine.tokenize`; the wait for the lock left out)."""

import statistics


def read(ctx, suffix):
    pt = ctx.get("program")
    spans = pt.named("engine.tokenize") if pt is not None else []
    if not spans:
        return None
    return statistics.median(s.end_ns - s.start_ns for s in spans) / 1e6
