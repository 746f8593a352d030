"""The model FLOPs of the slice-forwards in the traced window
(``yardstick/model.py`` ``generator_flops``) over the window's seconds and
the peak of the cell's dtype (989 TFLOP/s bf16, 495 TFLOP/s float32, whose
mixes state TF32 products). Layer: the whole serving step. Moves
``subject_slices_per_s``."""

from portbench.yardstick import model


def read(ctx):
    t = ctx.trace
    if not getattr(ctx, "slice_forwards", 0) or t.window_s <= 0:
        return None
    flops = ctx.slice_forwards * model.generator_flops(ctx.config)
    return 100.0 * flops / (t.window_s * model.PEAK_FLOPS[ctx.dtype])
