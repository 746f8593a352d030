"""Device-idle milliseconds inside the program's ``predict.forward`` spans
(``eval/predict.py`` ``EnsemblePredictor._ensemble``: one repeat's
generator forward, its mask and its running sum), per forward, over the
traced window. Layer: the forwards. Moves ``subject_slices_per_s``."""

from portbench.yardstick import program_spans


def read(ctx):
    return program_spans.idle_ms_per(ctx.trace, "predict.forward", ("predict.forward",))
