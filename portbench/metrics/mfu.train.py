"""The model FLOPs of the supersteps or steps in the traced window
(``yardstick/model.py``: ``gan_superstep_flops``, ``uresnet_step_flops``)
over the window's seconds and the peak of the cell's dtype (495 TFLOP/s
float32, whose mixes state TF32 products). Layer: the whole training step.
Moves ``train_slices_per_s``."""

from portbench.yardstick import model


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0:
        return None
    if getattr(ctx, "supersteps", None):
        flops = sum(model.gan_superstep_flops(ctx.config, ctx.train, n) for n in ctx.supersteps)
    elif getattr(ctx, "steps", 0):
        flops = ctx.steps * model.uresnet_step_flops(ctx.config, ctx.train)
    else:
        return None
    return 100.0 * flops / (t.window_s * model.PEAK_FLOPS[ctx.dtype])
