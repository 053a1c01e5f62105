"""`train_opt_idle_ms` (ms): the time within the window's optimizer
updates (the program's span `train.optimizer`, the clip's host read of the
norm included) in which no operation ran on the card, per window step
(`train.step` spans)."""


def read(ctx, suffix):
    pt = ctx.get("program")
    steps = pt.named("train.step") if pt is not None else []
    if not steps:
        return None
    idle, _ = pt.idle_within(pt.named("train.optimizer"))
    return idle / 1e6 / len(steps)
