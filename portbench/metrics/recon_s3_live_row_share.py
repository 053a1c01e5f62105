"""`recon_s3_live_row_share` (%): of the rows x steps the window's S3
decodes ran, the share before each row stopped (the program's counters
`s3.row_steps_live` over `s3.row_steps`)."""


def read(ctx, suffix):
    pt = ctx.get("program")
    rows = pt.counters.get("s3.row_steps") if pt is not None else None
    if not rows:
        return None
    return 100.0 * pt.counters.get("s3.row_steps_live", 0) / rows
