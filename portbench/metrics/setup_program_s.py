"""`setup_program_s.<cell kind>` (s): the program's own share of set-up:
the union of its spans `setup.construct` (building the model),
`setup.serving_layout` (the served layout from the float weights) and
`kernels.load` (a kernel library's first build and load) before the
window."""

from portbench.program_trace import SETUP_SPANS, merge


def read(ctx, suffix):
    pt = ctx.get("program")
    spans = [s for n in SETUP_SPANS for s in pt.named(n, window=False)] \
        if pt is not None else []
    if not spans:
        return None
    return sum(e - s for s, e in merge((s.start_ns, s.end_ns)
                                       for s in spans)) / 1e9
