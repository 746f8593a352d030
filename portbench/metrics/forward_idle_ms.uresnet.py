"""Device-idle milliseconds inside the program's ``uresnet.forward`` spans
(``train/uresnet_trainer.py`` ``UResNetTrainer.step``: the training
forward and the cross-entropy), per step, over the traced window. Layer:
the uresnet entry. Moves ``train_slices_per_s``."""

from portbench.yardstick import program_spans


def read(ctx):
    return program_spans.idle_ms_per(ctx.trace, "uresnet.step", ("uresnet.forward",))
