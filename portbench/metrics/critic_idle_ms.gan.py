"""Device-idle milliseconds inside the program's ``superstep.critic_y2``
and ``superstep.critic_dem`` spans (``train/gan_trainer.py``: both critics'
loops of D Adam steps), per superstep, over the traced window. Layer: the
training entry. Moves ``train_slices_per_s``."""

from portbench.yardstick import program_spans


def read(ctx):
    return program_spans.idle_ms_per(ctx.trace, "superstep",
                                     ("superstep.critic_y2", "superstep.critic_dem"))
