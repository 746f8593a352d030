"""Share of the traced window in which no operation ran on the card, in
training. Layer: the device. Moves ``train_slices_per_s``."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None
