"""The metric arithmetic on hand-built cases: the tail over all requests,
FLOP and byte counts, the idle share and the readers' attribution."""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest

from portbench import cell as cells
from portbench.yardstick import compare, model, stats
from portbench.yardstick.trace import Trace, _union

CFG = {"image_size": 256, "noise_size": 32, "first_fm": 32, "n_input_channels": 1, "n_out": 1}


def test_p95_takes_every_request():
    lat = [float(i) for i in range(1, 101)]  # 1..100 ms
    assert stats.p95(lat) == pytest.approx(95.05)
    assert stats.p95(list(reversed(lat))) == pytest.approx(95.05)
    assert math.isnan(stats.p95([1.0]))


def test_model_flops_from_the_published_shapes():
    n = 32
    conv = lambda side, cin, cout: 2.0 * side * side * cin * cout * 9  # noqa: E731
    levels = (conv(256, 1, n) + 2 * conv(256, n, n) + conv(128, n, 2 * n)
              + 2 * conv(128, 2 * n, 2 * n) + conv(64, 2 * n, 3 * n) + 2 * conv(64, 3 * n, 3 * n)
              + conv(32, 3 * n, 4 * n) + 2 * conv(32, 4 * n, 4 * n))
    decoder = (2.0 * 32 * 32 * 4 * n * 16 * n + conv(64, 7 * n, 3 * n) + 2 * conv(64, 3 * n, 3 * n)
               + 2.0 * 64 * 64 * 3 * n * 12 * n + conv(128, 5 * n, 2 * n)
               + 2 * conv(128, 2 * n, 2 * n)
               + 2.0 * 128 * 128 * 2 * n * 8 * n + conv(256, 3 * n, n) + 2 * conv(256, n, n))
    noise = 2.0 * 32 * (n + n * n) + 2 * 2.0 * 32 * n * n * 16
    head = 2.0 * 256 * 256 * n
    assert model.generator_flops(CFG) == pytest.approx(levels + decoder + noise + head)
    crit = (2.0 * 65536 * 25 * (16 + 16 * 16) + 2.0 * 16384 * 25 * (16 * 32 + 32 * 32)
            + 2.0 * 4096 * 9 * (32 * 64 + 64 * 64) + 2.0 * 1024 * 9 * (64 * 128 + 128 * 128)
            + 2.0 * 256 * 9 * (128 * 256 + 2 * 256 * 256) + 2.0 * 256 * 256 + 2.0 * 256)
    assert model.critic_flops(CFG) == pytest.approx(crit)


def test_kernel_units_count_each_input_and_output_once():
    units = dict((name, (f, b)) for name, f, b in model.generator_kernel_units(CFG, 2))
    assert len(units) == 13  # 8 convs, 2 pooled convs, 2 two-operand convs, 1 deconv
    f, b = units["m1.conv_out_pool"]
    px = 256 * 256
    assert f == 2.0 * px * 32 * 32 * 9
    assert b == 2 * (px * 32 + px * 32 + px * 32 // 4 + 9 * 32 * 32)
    least = model.least_seconds([("u", 989e12, 3.35e12)], 2, "bfloat16")
    assert least == pytest.approx(2.0)  # the larger of 1 s (FLOPs) and 1 s (bytes), twice
    assert model.least_seconds([("u", 0.0, 6.7e12)], 1, "float32") == pytest.approx(2.0)


def _trace(device, spans=(), host=(), t0=0, t1=1000):
    t = Trace.__new__(Trace)
    t.t0, t.t1, t.window_s = t0, t1, (t1 - t0) / 1e9
    t.device = list(device)
    t.host_spans = list(host)
    t.launch = {}
    t.spans = list(spans)
    t.busy = _union([(max(s, t0), min(e, t1)) for s, e, *_ in t.device])
    t.busy_s = sum(hi - lo for lo, hi in t.busy) / 1e9
    return t


def test_idle_share_counts_overlapping_streams_once():
    t = _trace([(100, 400, "k1", 0), (300, 500, "depgan::k2", 0), (700, 800, "Memcpy HtoD", 0)])
    assert t.busy_s == pytest.approx(500e-9)
    idle = cells.metric_reader("device_idle.serve")(SimpleNamespace(trace=t))
    assert idle == pytest.approx(50.0)
    assert t.kernel_seconds() == pytest.approx(500e-9)  # copies are not kernels
    assert t.kernel_seconds(port=True) == pytest.approx(200e-9)


@pytest.mark.parametrize("name, port", [
    ("void depgan::wg::(anonymous namespace)::s2d_wgmma<128, 2, false, 0, false>(Params)", True),
    ("void (anonymous namespace)::film_residual<float>(float const*, float*)", True),
    ("void depgan::s2d_gemm<float, 128, 0>(Problem<float>)", True),
    ("void at::native::elementwise_kernel<128, 4, at::native::Functor>(int)", False),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_cudnn", False),
    ("Memcpy HtoD (Pageable -> Device)", False)])
def test_port_kernels_are_known_by_name(name, port):
    from portbench.yardstick.trace import is_port_kernel

    assert is_port_kernel(name) is port


def test_idle_gaps_are_named_by_the_harness_span_open_on_each_thread():
    spans = [("bench.request", 1, 0, 1000), ("bench.forward", 1, 0, 300),
             ("bench.request", 2, 0, 1000)]
    t = _trace([(0, 200, "k", 0), (400, 500, "k", 0), (600, 1000, "k", 0)], spans=spans)
    gaps = dict((name, s) for name, s in t.idle_gaps())
    assert gaps == {"bench.forward+bench.request": pytest.approx(200e-9),
                    "bench.request+bench.request": pytest.approx(100e-9)}


def test_device_time_goes_to_the_range_its_launch_opened_in():
    t = _trace([(100, 200, "a", 1), (300, 600, "b", 2), (700, 750, "c", 3)],
               host=[("superstep.critic_y2", 0, 250), ("superstep.probe", 250, 1000)])
    t.launch = {1: 10, 2: 200, 3: 260}
    assert t.seconds_under(("superstep.critic_y2",)) == pytest.approx(400e-9)
    ctx = SimpleNamespace(trace=t, supersteps=[5])
    assert cells.metric_reader("critic_device_ms.gan")(ctx) == pytest.approx(400e-9 * 1e3)


def test_norm_gaps_take_the_worst_leaf_against_the_larger_norm():
    import torch

    ref = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([1e-9]), "c": torch.tensor([1.0])}
    prog = {"a": torch.tensor([3.0, 4.5]), "b": torch.tensor([2e-9]), "c": torch.tensor([1.0])}
    gaps = compare.leaf_gaps(prog, ref)
    assert max(gaps, key=gaps.get) == "a"
    assert gaps["a"] == pytest.approx((math.hypot(3, 4.5) - 5) / 5)
    assert gaps["b"] == pytest.approx(1e-9 / 1.0)  # against the median leaf's norm, 1
    assert compare.moving_leaves(ref) == {"a", "c"}  # b is under a thousandth of the median
    loss, at = compare.loss_gap([{"x": 1.0, "y": 0.0011}], [{"x": 1.0, "y": 0.001}])
    assert at == "step 1 y" and loss == pytest.approx(1e-4 / 0.5005)


@pytest.mark.parametrize("dtype, peak", [("float32", 495e12), ("bfloat16", 989e12)])
def test_shares_reach_100_at_the_dtypes_peak(dtype, peak):
    """The fastest rate a cell's FLOPs may run at: bf16's tensor-core peak,
    and for float32 cells, whose mixes state TF32 products, the TF32
    tensor-core peak (not the 67 TFLOP/s outside the tensor cores)."""
    assert model.PEAK_FLOPS[dtype] == peak
    forwards = 4200
    flops = forwards * model.generator_flops(CFG)
    ctx = SimpleNamespace(trace=_trace([], t1=round(flops / peak * 1e9)), config=CFG,
                          dtype=dtype, slice_forwards=forwards)
    assert cells.metric_reader("mfu.serve")(ctx) == pytest.approx(100.0, rel=1e-6)
