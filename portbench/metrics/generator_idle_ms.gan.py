"""Device-idle milliseconds inside the program's ``superstep`` spans and
outside both critics' loops (``train/gan_trainer.py``
``GanTrainer.superstep``: the draws, the index upload and the gather, the
generator's weight fold, the probe and the generator's step), per
superstep, over the traced window. Layer: the training entry. Moves
``train_slices_per_s``."""

from portbench.yardstick import program_spans


def read(ctx):
    return program_spans.idle_ms_per(ctx.trace, "superstep", ("superstep",),
                                     ("superstep.critic_y2", "superstep.critic_dem"))
