"""Device-idle milliseconds inside the program's ``uresnet.backward``
spans (``train/uresnet_trainer.py`` ``UResNetTrainer.step``: the gradients,
whose kernels autograd's thread launches inside the span's time), per
step, over the traced window. Layer: the uresnet entry. Moves
``train_slices_per_s``."""

from portbench.yardstick import program_spans


def read(ctx):
    return program_spans.idle_ms_per(ctx.trace, "uresnet.step", ("uresnet.backward",))
