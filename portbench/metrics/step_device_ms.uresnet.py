"""Device milliseconds of one ``UResNetTrainer.step``: the work launched
inside the harness's range around each step, over the traced steps. Moves
``train_slices_per_s``."""


def read(ctx):
    steps = getattr(ctx, "steps", 0)
    if not steps:
        return None
    seconds = ctx.trace.seconds_under(("bench.step",))
    return 1e3 * seconds / steps if seconds > 0 else None
