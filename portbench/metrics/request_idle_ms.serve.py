"""Device-idle milliseconds inside the program's ``predict`` spans and
outside their ``predict.forward`` ones (``eval/predict.py``
``EnsemblePredictor.predict``: the noise draw, the copies in, the
division and the copy out), per request, over the traced window. Layer:
the serving entry. Moves ``subject_p95_ms``."""

from portbench.yardstick import program_spans


def read(ctx):
    return program_spans.idle_ms_per(ctx.trace, "predict", ("predict",), ("predict.forward",))
