"""Reduction of a ``torch.profiler`` trace and of the harness's own spans
to the numbers the per-layer readers take.

The device's work is every kernel, copy and set that the profiler saw on
the card (CUPTI sees every thread's launches). ``busy_s`` is the union of
their intervals inside the traced window, so overlapping streams count
once. A kernel belongs to a host span when the runtime call that launched
it started inside the span. The harness's spans are taken on the host's
wall clock (``time.time_ns``, the profiler's base) by ``Spans``, because
the profiler records operators of the thread that started it only, and the
serving clients run on threads of their own.
"""

from __future__ import annotations

import bisect
import heapq
import threading
import time
from collections import defaultdict

# The kernels of the port's library (``depgan_tpu_torch/csrc``), by function
# name: some live in an anonymous namespace, so ``depgan::`` does not name
# them all.
PORT_KERNELS = frozenset((
    "chain_wgmma", "conv5_wgmma", "deconv_wgmma", "deint_merge", "deint_reshape_idx",
    "film_residual", "pool_s2d", "pool_to_s2d", "rowblk_wgmma", "s2d_chain", "s2d_gemm",
    "s2d_wgmma", "window_conv"))


def is_port_kernel(name: str) -> bool:
    """Whether a device operation's (demangled) name is a kernel of the
    port's library."""
    head = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    head = head.split("<", 1)[0].split("(", 1)[0]
    return "depgan::" in name or head.rsplit("::", 1)[-1] in PORT_KERNELS


class Spans:
    """Harness spans, (name, thread, start ns, end ns), from any thread."""

    def __init__(self):
        self.items: list[tuple[str, int, int, int]] = []
        self._lock = threading.Lock()

    def span(self, name: str):
        return _Span(self, name)


class _Span:
    def __init__(self, log: Spans, name: str):
        self.log, self.name = log, name

    def __enter__(self):
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        item = (self.name, threading.get_ident(), self.start, time.time_ns())
        with self.log._lock:
            self.log.items.append(item)
        return False


def profiler(device):
    """A ``torch.profiler`` over the host and, on a card, the device. Its
    events are read straight from the profiler's results (``Trace``), so
    stopping it parses nothing."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _top(by_name: dict, top: int) -> list[list]:
    return [[name, ns / 1e9] for name, ns in sorted(by_name.items(), key=lambda kv: -kv[1])][:top]


def _union(intervals):
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


class Trace:
    """The traced window [t0_ns, t1_ns] of one profile, with the
    harness's spans."""

    def __init__(self, prof, t0_ns: int, t1_ns: int, spans: Spans):
        from torch.autograd import DeviceType

        self.t0, self.t1 = t0_ns, t1_ns
        self.window_s = (t1_ns - t0_ns) / 1e9
        self.device = []  # (start, end, name, linked correlation)
        self.host_spans = []  # the program's record_function ranges: (name, start, end)
        launch = {}  # runtime correlation id -> start
        device = []
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    device.append((start, end, e.name(), e.linked_correlation_id()))
            elif e.is_user_annotation():
                self.host_spans.append((e.name(), start, end))
            elif e.correlation_id():
                launch[e.correlation_id()] = start
        # The profiler mirrors each range onto the device's timeline under
        # the range's name: that is no device work.
        ranges = {name for name, _, _ in self.host_spans}
        self.device = [d for d in device if d[2] not in ranges]
        self.launch = launch
        self.spans = [s for s in spans.items if s[2] < t1_ns and s[3] > t0_ns]
        clipped = [(max(s, t0_ns), min(e, t1_ns)) for s, e, *_ in self.device if e > t0_ns
                   and s < t1_ns]
        self.busy = _union(clipped)
        self.busy_s = sum(hi - lo for lo, hi in self.busy) / 1e9

    def kernel_seconds(self, port: bool = False) -> float:
        """Device seconds of the kernels (not copies or sets); with
        ``port``, of the port's kernels only."""
        return sum(e - s for s, e, name, _ in self.device
                   if not name.startswith(("Memcpy", "Memset"))
                   and (not port or is_port_kernel(name))) / 1e9

    def seconds_under(self, names: tuple[str, ...]) -> float:
        """Device seconds of the work launched inside the program's ranges
        named ``names``."""
        ranges = sorted((s, e) for n, s, e in self.host_spans if n in names)
        starts = [s for s, _ in ranges]
        total = 0
        for s, e, _, corr in self.device:
            t = self.launch.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ranges[i][0] <= t <= ranges[i][1]:
                total += e - s
        return total / 1e9

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took most time, by name."""
        by_name = defaultdict(int)
        for s, e, name, _ in self.device:
            by_name[name] += e - s
        return _top(by_name, top)

    def idle_gaps(self, top: int = 10) -> list[list]:
        """Idle device time by the harness spans open at each gap's start
        (the innermost span of each thread, joined), longest first."""
        gaps, prev = [], self.t0
        for lo, hi in self.busy + [[self.t1, self.t1]]:
            if lo > prev:
                gaps.append((prev, lo))
            prev = max(prev, hi)
        events = sorted((s, e, name, tid) for name, tid, s, e in self.spans)
        active: list = []  # heap of (end, -start, name, tid)
        by_name = defaultdict(int)
        j = 0
        for lo, hi in gaps:
            while j < len(events) and events[j][0] <= lo:
                s, e, name, tid = events[j]
                heapq.heappush(active, (e, -s, name, tid))
                j += 1
            while active and active[0][0] < lo:
                heapq.heappop(active)
            inner = {}
            for e, neg_s, name, tid in active:
                if tid not in inner or -neg_s > inner[tid][0]:
                    inner[tid] = (-neg_s, name)
            key = "+".join(sorted(name for _, name in inner.values())) or "no harness span"
            by_name[key] += hi - lo
        return _top(by_name, top)
