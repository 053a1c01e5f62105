"""`tokenize_lock_wait_ms_p95` (ms): the 95th percentile of the window's
waits for the engine's lock (the program's span `engine.lock_wait`) of
Tokenize requests (those with an `engine.tokenize` span under the same
request id)."""

from portbench.common import percentile


def read(ctx, suffix):
    pt = ctx.get("program")
    if pt is None:
        return None
    calls = {s.call for s in pt.named("engine.tokenize")}
    waits = [s.end_ns - s.start_ns for s in pt.named("engine.lock_wait")
             if s.call in calls]
    return percentile(waits, 95) / 1e6 if waits else None
