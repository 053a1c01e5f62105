"""`recon_s3_sync_ms_per_step` (ms): the host's time in the S3 loop's read
of `done` (the program's span `s3.done_read`, which waits for the step
before it), summed over the window, over the steps run (`s3.steps`)."""


def read(ctx, suffix):
    pt = ctx.get("program")
    steps = pt.counters.get("s3.steps") if pt is not None else None
    if not steps:
        return None
    reads = pt.named("s3.done_read")
    return sum(s.end_ns - s.start_ns for s in reads) / 1e6 / steps
