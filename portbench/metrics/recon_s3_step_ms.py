"""`recon_s3_step_ms` (ms): the window's seconds in the S3 decode (a
harness span on `speech_decoder.generate`, synchronized at its end) over
the decode steps it ran, prefill included."""


def read(ctx, suffix):
    spans, steps = ctx.get("spans", {}).get("s3_generate"), ctx.get("s3_steps")
    if not spans or not steps:
        return None
    return 1000.0 * sum(spans) / steps
