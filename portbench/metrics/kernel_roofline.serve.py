"""Share of their roofline that the port's kernels reach in serving: the
least time of the generator's level-1/2 layers over the traced window's
slice-forwards (``yardstick/model.py`` ``generator_kernel_units``, from the
configuration's shapes), over the device time of the port's kernels
(``yardstick/trace.py`` ``PORT_KERNELS``). None where no such kernel ran (the plain
path). Moves ``subject_slices_per_s``."""

from portbench.yardstick import model


def read(ctx):
    seconds = ctx.trace.kernel_seconds(port=True)
    if seconds <= 0 or not getattr(ctx, "slice_forwards", 0):
        return None
    units = model.generator_kernel_units(ctx.config, 2 if ctx.dtype == "bfloat16" else 4)
    return 100.0 * model.least_seconds(units, ctx.slice_forwards, ctx.dtype) / seconds
