"""Per-layer metrics: `<base>.py` reads every metric named `<base>` or
`<base>.<suffix>` from the context a traced run leaves (`spans`: seconds
of each harness span; `trace`: common.read_trace's summary; `window_s`;
`shapes`: the cell's shape context, the as-run config and the window's
work by part of the model (portbench/rooflines/__init__.py); `launches`:
the program's launch counters over the window; `model_flops`; and what a
cell adds).  A reader returns None when it finds nothing to read, and the
metric is then left out of the line."""
