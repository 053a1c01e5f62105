"""`recon_s3_step_device_ms` (ms): the device time of the window's
operations launched inside the program's `s3.step` spans, over the steps
run (`s3.steps`): the S3 step's device time, with the host's pace left
out."""


def read(ctx, suffix):
    pt = ctx.get("program")
    steps = pt.counters.get("s3.steps") if pt is not None else None
    if not steps:
        return None
    return pt.device_ns_under("s3.step") / 1e6 / steps
