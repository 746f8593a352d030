"""Share of the traced window in which no operation ran on the card, in
serving. Layer: the device. Moves ``subject_slices_per_s``."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None
