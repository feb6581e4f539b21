"""The traced part of a `--trace 1` run: torch.profiler over it, and the
reduction of its events to what the per-layer metrics read.

Spans are the benchmark's own, around calls into the program's layers,
named "hgbench.<layer call>", recorded on whatever thread makes the call,
and keyed "main" on the main thread, "other" elsewhere. Two markers, a
profiled record_function at the traced part's start and end, put the
spans' host clock on the profiler's. CUPTI records every thread's runtime
calls and every device operation, but the thread ids it gives a runtime
call match neither Python's native id nor its ident on the card; so the
main thread's id is CUPTI's id of the runtime calls that the profiler
links to a PyTorch operation on the main thread (the profiler records
those on the thread that started it), and a call with another id is
another thread's. A device operation belongs to a span when the runtime
call that launched it (matched by CUPTI correlation id) ran inside the
span, on the span's key; so a main-thread span holds the device time of
every kernel launched inside the call, whatever the kernels are named. A
span on another thread would take every other thread's launches in its
time: no metric reads one.
"""

from __future__ import annotations

import bisect
import contextlib
import sys
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "hgbench."
_LAUNCH_PREFIXES = ("cuda", "cuLaunch", "cuMemcpy", "cuMemset")


@dataclass
class Span:
    name: str
    key: str  # "main" or "other": the thread it was recorded on
    start: int  # ns, profiler clock
    end: int


@dataclass
class DeviceOp:
    name: str
    start: int
    end: int
    corr: int


@dataclass
class TraceData:
    """The reduced trace: spans, device operations, and for each device
    operation the key of the host thread and the time of its launch (None
    where the trace holds no launch for it)."""

    spans: List[Span]
    ops: List[DeviceOp]
    launch: List[Optional[Tuple[str, int]]]
    window_s: float

    @staticmethod
    def from_events(spans, ops, launches, window_s):
        """spans, ops as lists; launches: {corr: (key, start_ns)}."""
        ops = sorted(ops, key=lambda o: o.start)
        return TraceData(spans=sorted(spans, key=lambda s: s.start), ops=ops,
                         launch=[launches.get(o.corr) for o in ops], window_s=window_s)

    # -- device time ---------------------------------------------------------

    def kernels(self):
        """The device operations that are kernels (no copies, no fills)."""
        return [o for o in self.ops if not o.name.startswith(("Memcpy", "Memset"))]

    def busy_intervals(self):
        """The union of the device operations' intervals, in order."""
        out = []
        for o in self.ops:
            if out and o.start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], o.end)
            else:
                out.append([o.start, o.end])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    # -- spans ---------------------------------------------------------------

    def spans_named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == SPAN_PREFIX + name]

    def ops_by_span(self, name: str) -> List[Tuple[Span, List[DeviceOp]]]:
        """Each span of `name` with the device operations launched in it."""
        spans = self.spans_named(name)
        starts = [s.start for s in spans]
        groups: List[List[DeviceOp]] = [[] for _ in spans]
        for o, la in zip(self.ops, self.launch):
            if la is None:
                continue
            i = bisect.bisect_right(starts, la[1]) - 1
            # Spans of one name do not nest; look back a little for one on
            # the launch's thread that still covers it.
            for j in range(i, max(i - 8, -1), -1):
                s = spans[j]
                if s.key == la[0] and s.start <= la[1] <= s.end:
                    groups[j].append(o)
                    break
        return list(zip(spans, groups))

    def host_labels(self, times, key: str = "main") -> List[str]:
        """The innermost span of the thread `key` open at each of `times`
        (spans of one thread nest), by one sweep."""
        spans = [sp for sp in self.spans if sp.key == key]
        events = [(sp.start, 0, i) for i, sp in enumerate(spans)] + [(sp.end, 2, i) for i, sp in enumerate(spans)]
        events += [(t, 1, q) for q, t in enumerate(times)]
        events.sort()
        stack: List[int] = []
        out = ["outside spans"] * len(times)
        for _, kind, i in events:
            if kind == 0:
                stack.append(i)
            elif kind == 2:
                if stack and stack[-1] == i:
                    stack.pop()
                elif i in stack:
                    stack.remove(i)
            elif stack:
                out[i] = spans[stack[-1]].name[len(SPAN_PREFIX):]
        return out

    # -- breakdown -----------------------------------------------------------

    def breakdown(self) -> dict:
        """The ten device operations with most time, by name, and the idle
        time between device operations summed by what the host's main
        thread was in (its innermost span at each gap's midpoint), the
        ten largest."""
        by_op: Dict[str, float] = {}
        for o in self.ops:
            by_op[o.name] = by_op.get(o.name, 0.0) + (o.end - o.start) / 1e9
        busy = self.busy_intervals()
        gaps = [(a, b) for (_, a), (b, _) in zip(busy, busy[1:])]
        by_label: Dict[str, float] = {}
        for (a, b), label in zip(gaps, self.host_labels([(a + b) // 2 for a, b in gaps])):
            by_label[label] = by_label.get(label, 0.0) + (b - a) / 1e9
        top = lambda d: [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_label)}


def _kineto_events(prof):
    results = prof.profiler.kineto_results
    return results.events() if results is not None else []


def _key() -> str:
    """The current thread's key: "main" or "other"."""
    return "main" if threading.current_thread() is threading.main_thread() else "other"


def reduce_profile(prof, window_s: float, host_spans, marks) -> TraceData:
    """TraceData from a stopped torch.profiler.profile, the host spans
    [(name, key, start, end)] on the host clock and the host clock's
    readings at the profiled markers."""
    cuda = torch.autograd.DeviceType.CUDA
    ops, runtime, marker_ns = [], [], []
    op_tid: Dict[int, int] = {}
    marker_tid = None
    for e in _kineto_events(prof):
        name = e.name()
        if e.device_type() == cuda:
            if name.startswith(SPAN_PREFIX) or e.is_user_annotation():
                continue  # an annotation's shadow on the device's timeline, not an operation
            ops.append(DeviceOp(name, e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id()))
        elif name.startswith(_LAUNCH_PREFIXES):
            runtime.append((e.correlation_id(), e.linked_correlation_id(), e.start_thread_id(), e.start_ns()))
        else:
            op_tid[e.correlation_id()] = e.start_thread_id()
            if name == CLOCK_MARK:
                marker_ns.append(e.start_ns())
                marker_tid = e.start_thread_id()
    # The main thread's runtime calls: CUPTI's thread id of those linked to
    # a PyTorch operation on the main thread (a call on a thread the
    # profiler does not record is linked to nothing, id 0), and every call
    # with that id, the launches of the program's own kernels included.
    main = {tid for _, linked, tid, _ in runtime if linked and marker_tid is not None
            and op_tid.get(linked) == marker_tid}
    print(f"trace: {len(ops)} device operations, {len(runtime)} runtime calls ({len(main)} thread id(s) of the "
          f"main thread's), {len(host_spans)} spans, {len(marker_ns)} of {len(marks)} clock marks", file=sys.stderr)
    spans = []
    if len(marker_ns) == len(marks) and marks:
        offset = sum(p - h for p, h in zip(sorted(marker_ns), marks)) / len(marks)
        spans = [Span(SPAN_PREFIX + n, key, int(a + offset), int(b + offset)) for n, key, a, b in host_spans]
    wanted = {o.corr for o in ops}
    launches = {corr: ("main" if tid in main else "other", t) for corr, _, tid, t in runtime if corr in wanted}
    return TraceData.from_events(spans, ops, launches, window_s)


class _HostSpans:
    """The benchmark's spans, recorded while a Tracer runs, from any thread."""

    def __init__(self):
        self.on = False
        self.items = []
        self.lock = threading.Lock()


HOST_SPANS = _HostSpans()
CLOCK_MARK = SPAN_PREFIX + "clock"


@contextlib.contextmanager
def span(name: str):
    """A span of the benchmark's own around the block, while a Tracer runs."""
    if not HOST_SPANS.on:
        yield
        return
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        t1 = time.perf_counter_ns()
        with HOST_SPANS.lock:
            HOST_SPANS.items.append((name, _key(), t0, t1))


class Tracer:
    """torch.profiler over a block of the run, CPU and CUDA activities, and
    the benchmark's spans; `data` holds the reduced trace afterwards. On a
    machine without a card it records the host side only."""

    def __init__(self, device: torch.device):
        self.device = device
        self.data: Optional[TraceData] = None

    @staticmethod
    def _mark() -> float:
        """The host clock at a profiled marker's start."""
        from torch.profiler import record_function

        t0 = time.perf_counter_ns()
        with record_function(CLOCK_MARK):
            t1 = time.perf_counter_ns()
        return (t0 + t1) / 2

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self._sync()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._marks = [self._mark()]
        with HOST_SPANS.lock:
            HOST_SPANS.items = []
            HOST_SPANS.on = True
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        window_s = time.perf_counter() - self._t0
        HOST_SPANS.on = False
        self._marks.append(self._mark())
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.data = reduce_profile(self._prof, window_s, list(HOST_SPANS.items), self._marks)
        return False

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Forwarding:
    """A wrapper of a function that keeps the wrapped one's attributes: the
    program counts calls on its functions' attributes (solve_ct_window_
    batched.assemblies and the like), through whatever its global name
    holds."""

    def __init__(self, fn, inner):
        self.__dict__.update(_fn=fn, _inner=inner)

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __setattr__(self, name, value):
        setattr(self._inner, name, value)


class SpanPatches:
    """Wraps attributes of the program's modules or objects in spans, for
    the traced part only: (owner, attribute, span name) triples; undone on
    exit. A wrapper may also record each call's arguments (args, kwargs),
    for the work counts of a roofline."""

    def __init__(self, patches, record: Optional[Dict[str, list]] = None):
        self._patches = list(patches)
        self._saved = []
        self.record = record if record is not None else {}
        self._lock = threading.Lock()

    def __enter__(self):
        for owner, attr, name in self._patches:
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn, attr in getattr(owner, "__dict__", {})))
            calls = self.record.get(name)

            def wrapped(*a, __fn=fn, __name=name, __calls=calls, **kw):
                with span(__name):
                    if __calls is not None:
                        with self._lock:
                            __calls.append((a, kw))
                    return __fn(*a, **kw)

            setattr(owner, attr, Forwarding(wrapped, fn))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn, own in reversed(self._saved):
            if own or not hasattr(type(owner), attr):
                setattr(owner, attr, fn)
            else:
                delattr(owner, attr)
        self._saved.clear()
        return False
