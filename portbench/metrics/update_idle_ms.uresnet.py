"""Device-idle milliseconds inside the program's ``uresnet.step`` spans and
outside their forward and backward (``train/uresnet_trainer.py``
``UResNetTrainer.step``: the index upload and the gathers, Adam, the new
BatchNorm statistics), per step, over the traced window. Layer: the
uresnet entry. Moves ``train_slices_per_s``."""

from portbench.yardstick import program_spans


def read(ctx):
    return program_spans.idle_ms_per(ctx.trace, "uresnet.step", ("uresnet.step",),
                                     ("uresnet.forward", "uresnet.backward"))
