"""The port's spans (``utils/profiling.py`` ``span``): nothing recorded and
no clock read with no profiler running; under ``torch.profiler`` a record
on the profiler's clock around the operators run inside it, with its
thread, parent and root, and the profiler's own range; and the spans of the
three entry points (``EnsemblePredictor.predict``, ``UResNetTrainer.step``,
``GanTrainer.superstep``). CPU, image 16, first_fm 4."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from depgan_tpu_torch.config import GanTrainConfig, ModelConfig, UResNetTrainConfig
from depgan_tpu_torch.eval.predict import EnsemblePredictor
from depgan_tpu_torch.models import init_generator
from depgan_tpu_torch.train.gan_trainer import GanTrainer
from depgan_tpu_torch.train.uresnet_trainer import UResNetTrainer
from depgan_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def no_spans():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    class NoClock:
        def __getattr__(self, name):
            raise AssertionError(f"time.{name} read with no profiler running")

    def no_range(name):
        raise AssertionError("record_function built with no profiler running")

    monkeypatch.setattr(profiling, "time", NoClock())
    monkeypatch.setattr(profiling, "record_function", no_range)
    first = profiling.span("a")
    assert first is profiling.span("b")  # one shared context, nothing allocated
    with first:
        with profiling.span("c"):
            torch.ones(2).sum()
    assert profiling.spans() == []


def test_on_brackets_the_operators_and_the_range():
    a = torch.ones(32, 32)
    with cpu_profile() as prof:
        with profiling.span("outer"):
            (a @ a).relu()
    (rec,) = profiling.spans()
    assert (rec.name, rec.parent, rec.root) == ("outer", None, rec.id)
    assert rec.thread == threading.get_ident()
    events = list(prof.profiler.kineto_results.events())
    ops = [e for e in events if e.name() in ("aten::mm", "aten::relu")]
    assert {e.name() for e in ops} == {"aten::mm", "aten::relu"}
    for e in ops:
        assert rec.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= rec.end_ns
    assert any(e.is_user_annotation() and e.name() == "outer" for e in events)


def test_a_second_thread_records_its_own_thread_id():
    def work():
        with profiling.span("worker"):
            torch.ones(4).sum()

    with cpu_profile():
        with profiling.span("main"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    got = by_name(profiling.spans())
    (main,), (worker,) = got["main"], got["worker"]
    assert worker.thread == t.ident != main.thread == threading.get_ident()
    assert worker.parent is None and worker.root == worker.id  # a root of its own thread


def test_nested_spans_carry_parent_and_root():
    with cpu_profile():
        with profiling.span("a"):
            with profiling.span("b"):
                with profiling.span("c"):
                    pass
            with profiling.span("d"):
                pass
        with profiling.span("e"):
            pass
    got = {r.name: r for r in profiling.spans()}
    a, b, c, d, e = (got[k] for k in "abcde")
    assert a.parent is None and a.root == a.id
    assert (b.parent, c.parent, d.parent) == (a.id, b.id, a.id)
    assert {b.root, c.root, d.root} == {a.id}
    assert e.parent is None and e.root == e.id != a.id
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= d.start_ns
    assert d.end_ns <= a.end_ns <= e.start_ns


GEN = ModelConfig(image_size=16, first_fm=4)


def run_predict():
    pred = EnsemblePredictor(GEN, init_generator(GEN, seed=0), n_repeat=3, device="cpu")
    calls = []
    forward = pred._forward
    pred._forward = lambda x, z: calls.append(1) or forward(x, z)
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(2, 16, 16, 1)).astype(np.float32)
    with cpu_profile() as prof:
        pred.predict(x, np.ones((2, 16, 16), np.float32))
    assert len(calls) == 3
    return prof, {"predict": 1, "predict.forward": 3}, "predict"


def run_uresnet_step():
    cfg = ModelConfig(image_size=16, first_fm=4, n_out=4, dropout_mode="uresnet")
    trainer = UResNetTrainer(cfg, UResNetTrainConfig(batch_size=2), device="cpu")
    state = trainer.init_state(seed=0)
    gen = torch.Generator().manual_seed(0)
    x = torch.rand((4, 16, 16, 1), generator=gen)
    y = torch.nn.functional.one_hot(torch.randint(0, 4, (4, 16, 16), generator=gen), 4).float()
    noise = torch.randn((4, cfg.noise_size, 1), generator=gen)
    with cpu_profile() as prof:
        trainer.step(state, x, y, noise, [0, 2], generator=gen)
    return prof, {"uresnet.step": 1, "uresnet.forward": 1, "uresnet.backward": 1}, "uresnet.step"


def run_superstep():
    train = GanTrainConfig(batch_size=2, d_iters=1, warmup_d_iters=1, k_noise=2)
    trainer = GanTrainer(GEN, train, device="cpu")
    state = trainer.init_state(seed=0)
    gen = torch.Generator().manual_seed(0)
    x, y = torch.rand((4, 16, 16, 1), generator=gen), torch.rand((4, 16, 16, 1), generator=gen)
    with cpu_profile() as prof:
        trainer.superstep(state, x, y, np.array([[1, 3]]), 1, generator=gen)
    names = ("superstep", "superstep.critic_y2", "superstep.critic_dem", "superstep.probe",
             "superstep.generator_step")
    return prof, dict.fromkeys(names, 1), "superstep"


@pytest.mark.parametrize("entry", [run_predict, run_uresnet_step, run_superstep],
                         ids=["predict", "uresnet.step", "superstep"])
def test_entry_points_record_their_spans(entry):
    """Each entry point records its spans under one root, and the profiler
    shows each as a range (``critic_device_ms.gan`` reads the critics')."""
    prof, want, root_name = entry()
    got = by_name(profiling.spans())
    assert {k: len(v) for k, v in got.items()} == want
    (root,) = got[root_name]
    assert root.parent is None
    for rec in profiling.spans():
        assert rec.root == root.id
        assert root.start_ns <= rec.start_ns <= rec.end_ns <= root.end_ns
    ranges = {e.name() for e in prof.profiler.kineto_results.events() if e.is_user_annotation()}
    assert set(want) <= ranges
