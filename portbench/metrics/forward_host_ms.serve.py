"""Host milliseconds of one generator forward call in serving: the
harness's span around each call of the predictor's forward, no
synchronisation, averaged over the traced window's forwards. Layer: the
serving entry (``eval/predict.py`` ``EnsemblePredictor``). Moves
``subject_p95_ms``."""


def read(ctx):
    host = getattr(ctx, "forward_host_s", None)
    if not host:
        return None
    return 1e3 * sum(host) / len(host)
