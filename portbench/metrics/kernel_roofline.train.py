"""Share of their roofline that the port's kernels reach in training: the
least time of the layers they carry over the traced supersteps or steps,
from the configuration's shapes (``yardstick/model.py``): in the GAN
superstep the generator's level-1/2 layers and the critics' 5x5 levels
(``gan_superstep_kernel_seconds``), in the UResNet step the FiLM sites'
modulation (``film_site_units``); over the device time of the port's
kernels (``yardstick/trace.py`` ``PORT_KERNELS``). Moves ``train_slices_per_s``."""

from portbench.yardstick import model


def read(ctx):
    seconds = ctx.trace.kernel_seconds(port=True)
    if seconds <= 0:
        return None
    nbytes = 2 if ctx.dtype == "bfloat16" else 4
    if getattr(ctx, "supersteps", None):
        least = sum(model.gan_superstep_kernel_seconds(ctx.config, ctx.train, n, ctx.dtype)
                    for n in ctx.supersteps)
    elif getattr(ctx, "steps", 0):
        least = model.least_seconds(model.film_site_units(ctx.config, nbytes),
                                    ctx.steps * ctx.train["batch_size"], ctx.dtype)
    else:
        return None
    return 100.0 * least / seconds
