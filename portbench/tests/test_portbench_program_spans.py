"""The device-idle time inside the program's spans
(``yardstick/program_spans.py``) and the seven readers built on it, on
hand-built busy intervals and span records: nesting, ``outside``, two
threads whose spans overlap counted once, spans clipped at the window's
edges, and a program that keeps no spans."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from depgan_tpu_torch.utils import profiling
from portbench import cell as cells
from portbench.yardstick import program_spans
from portbench.yardstick.trace import Trace, _union


def _trace(busy, t0=0, t1=1000):
    t = Trace.__new__(Trace)
    t.t0, t.t1, t.window_s = t0, t1, (t1 - t0) / 1e9
    t.device = [(s, e, "k", 0) for s, e in busy]
    t.host_spans, t.launch, t.spans = [], {}, []
    t.busy = _union([(max(s, t0), min(e, t1)) for s, e in busy])
    t.busy_s = sum(hi - lo for lo, hi in t.busy) / 1e9
    return t


def _records(monkeypatch, *items):
    """Program spans (name, thread, start, end); ids in order, no parents:
    the reader uses names, threads and times only."""
    recs = [profiling.SpanRecord(name, i, None, i, tid, s, e)
            for i, (name, tid, s, e) in enumerate(items, 1)]
    monkeypatch.setattr(profiling, "spans", lambda: recs)


def _read(name, trace):
    return cells.metric_reader(name)(SimpleNamespace(trace=trace))


def test_nested_phases_split_the_uresnet_step(monkeypatch):
    _records(monkeypatch, ("uresnet.forward", 1, 100, 400), ("uresnet.backward", 1, 400, 800),
             ("uresnet.step", 1, 0, 1000))
    t = _trace([(200, 300), (500, 600)])
    ns = 1e-6  # one nanosecond in ms
    assert program_spans.idle_inside(t, ("uresnet.forward",)) == pytest.approx(200e-9)
    assert _read("forward_idle_ms.uresnet", t) == pytest.approx(200 * ns)
    assert _read("backward_idle_ms.uresnet", t) == pytest.approx(300 * ns)
    assert _read("update_idle_ms.uresnet", t) == pytest.approx(300 * ns)  # [0, 100], [800, 1000]
    # the three phases cover the window's idle time, once
    assert program_spans.idle_inside(t, ("uresnet.step",)) == pytest.approx(1e-9 * (1000 - 200))


def test_critic_and_generator_phases_per_superstep(monkeypatch):
    _records(monkeypatch, ("superstep.critic_y2", 1, 100, 400),
             ("superstep.critic_dem", 1, 400, 600), ("superstep", 1, 100, 900),
             ("superstep", 1, 900, 1000))
    t = _trace([(150, 300), (450, 500), (700, 800)])
    assert program_spans.count(t, "superstep") == 2
    # critics: [100, 150], [300, 450], [500, 600]; the rest: [600, 700], [800, 1000]
    assert _read("critic_idle_ms.gan", t) == pytest.approx(300e-6 / 2)
    assert _read("generator_idle_ms.gan", t) == pytest.approx(300e-6 / 2)


def test_two_threads_overlapping_count_once_and_outside_holds_across_threads(monkeypatch):
    _records(monkeypatch, ("predict.forward", 1, 100, 500), ("predict.forward", 2, 300, 700),
             ("predict", 1, 0, 600), ("predict", 2, 200, 1000))
    t = _trace([])
    assert program_spans.idle_inside(t, ("predict.forward",)) == pytest.approx(600e-9)
    assert program_spans.count(t, "predict.forward") == 2
    assert _read("forward_idle_ms.serve", t) == pytest.approx(600e-6 / 2)
    # inside a predict of either thread, outside every thread's forward
    assert _read("request_idle_ms.serve", t) == pytest.approx(400e-6 / 2)


def test_spans_are_clipped_at_the_window_and_counted_where_they_end(monkeypatch):
    _records(monkeypatch, ("predict", 1, 0, 500), ("predict", 1, 800, 1200),
             ("predict", 1, 1300, 1400))
    t = _trace([(300, 400)], t0=100, t1=900)
    # [100, 300], [400, 500], [800, 900]
    assert program_spans.idle_inside(t, ("predict",)) == pytest.approx(400e-9)
    assert program_spans.count(t, "predict") == 1


@pytest.mark.parametrize("name", ["forward_idle_ms.serve", "request_idle_ms.serve",
                                  "forward_idle_ms.uresnet", "backward_idle_ms.uresnet",
                                  "update_idle_ms.uresnet", "critic_idle_ms.gan",
                                  "generator_idle_ms.gan"])
def test_no_program_spans_read_none(name, monkeypatch):
    t = _trace([(0, 100)])
    _records(monkeypatch)  # a program that recorded nothing
    assert _read(name, t) is None
    monkeypatch.delattr(profiling, "spans")  # a program that keeps no spans
    assert _read(name, t) is None
    assert program_spans.idle_inside(t, ("predict",)) == 0.0
