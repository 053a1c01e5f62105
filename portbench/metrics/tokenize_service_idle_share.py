"""`tokenize_service_idle_share` (%): the share of the union of the
window's `engine.tokenize` spans in which no operation ran on the card,
on the device trace's clock (portbench/program_trace.py)."""


def read(ctx, suffix):
    pt = ctx.get("program")
    spans = pt.named("engine.tokenize") if pt is not None else []
    idle, total = pt.idle_within(spans) if spans else (0, 0)
    return 100.0 * idle / total if total else None
