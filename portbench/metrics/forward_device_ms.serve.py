"""Device milliseconds of one ensemble forward (42 slices): every kernel of
the traced window over its forwards (the mask and the running sum are in
the forward's loop). Layer: the forwards (``ops/fast_gen.py``
``FastGenerator``, or ``models/generator.py`` ``GenUNet2D``). Moves
``subject_slices_per_s``."""


def read(ctx):
    forwards = getattr(ctx, "forwards", 0)
    seconds = ctx.trace.kernel_seconds()
    if not forwards or seconds <= 0:
        return None
    return 1e3 * seconds / forwards
