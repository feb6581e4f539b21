"""Section timing into the process-wide metrics registry, and the span
recorder (counterpart of section, global_factory and report in
hectorgrapher_tpu/common/profiling.py; its JAX device-trace helpers are not
ported: torch.profiler takes their place).

- section(name): always on. Observes its wall time into the
  hg_section_seconds histogram (served by the Prometheus exporter), and
  while recording is on is a span as well. For coarse stages: one per
  scan, work item, round or solve.
- span(name): recorded only between recording()'s enter and exit. Off, a
  span is one read of a module flag and returns a shared no-op context
  (no clock read, no allocation).

A span keeps (name, thread, start_ns, end_ns, parent): the clock is
time.perf_counter_ns(); parent is the name of the span open on the same
thread when it began (spans nest per thread).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional

from hectorgrapher_tpu_torch.metrics.metrics import GLOBAL_FACTORY, FamilyFactory

_factory = GLOBAL_FACTORY
_sections = _factory.new_histogram_family(
    "hg_section_seconds",
    "Wall time per instrumented section",
    boundaries=[1e-4, 3e-4, 1e-3, 3e-3, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0],
)
_lock = threading.Lock()
_metrics_cache: Dict[str, object] = {}

DEFAULT_CAPACITY = 1_000_000


def global_factory() -> FamilyFactory:
    """The process-wide registry (ref: metrics/register.cc RegisterAllMetrics)."""
    return _factory


class Span(NamedTuple):
    name: str
    thread: int  # threading.get_ident() of the recording thread
    start_ns: int
    end_ns: int
    parent: Optional[str]


class Recording:
    """What one recording() holds: spans in the order they ended (at most
    `capacity`, then `dropped` counts the rest)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self.spans: List[Span] = []
        self.dropped = 0
        self.start_ns = time.perf_counter_ns()
        self.end_ns: Optional[int] = None
        self._lock = threading.Lock()

    def _add_span(self, name, start_ns, end_ns, parent) -> None:
        if len(self.spans) >= self.capacity:
            with self._lock:
                self.dropped += 1
            return
        self.spans.append(Span(name, threading.get_ident(), start_ns, end_ns, parent))

    def spans_named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


_ON = False
_RECORDING: Optional[Recording] = None
_local = threading.local()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("name", "start", "parent")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _stack()
        self.parent = st[-1] if st else None
        st.append(self.name)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _local.stack.pop()
        rec = _RECORDING
        if rec is not None and rec.start_ns <= self.start:
            rec._add_span(self.name, self.start, end, self.parent)
        return False


def span(name: str):
    """A span around the block while recording is on; otherwise a shared
    no-op context."""
    if not _ON:
        return _NOOP
    return _Span(name)


class _Section:
    __slots__ = ("metric", "span", "t0")

    def __init__(self, metric, name: str):
        self.metric = metric
        self.span = _Span(name) if _ON else None

    def __enter__(self):
        if self.span is not None:
            self.span.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.metric.observe(time.perf_counter() - self.t0)
        if self.span is not None:
            self.span.__exit__(*exc)
        return False


def _section_metric(name: str):
    metric = _metrics_cache.get(name)
    if metric is None:
        with _lock:
            metric = _metrics_cache.get(name)
            if metric is None:
                metric = _sections.add({"section": name})
                _metrics_cache[name] = metric
    return metric


def section(name: str):
    """Time a code section into the hg_section_seconds histogram family,
    labelled section=name, and while recording is on, a span of the same
    name. Host wall time: device work still queued when the section ends
    is not in it."""
    return _Section(_section_metric(name), name)


def section_since(name: str, start_ns: int) -> None:
    """An interval that began at start_ns (perf_counter_ns, possibly on
    another thread) and ends now, on this thread: into hg_section_seconds
    as section(name) would time it, and while recording is on a span."""
    end = time.perf_counter_ns()
    _section_metric(name).observe((end - start_ns) / 1e9)
    rec = _RECORDING
    if _ON and rec is not None and rec.start_ns <= start_ns:
        st = _stack()
        rec._add_span(name, start_ns, end, st[-1] if st else None)


class recording:
    """Switches recording on for the block; the Recording it yields holds
    the spans once it closes. One recording at a time."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._capacity = capacity
        self.rec: Optional[Recording] = None

    def __enter__(self) -> Recording:
        global _ON, _RECORDING
        if _RECORDING is not None:
            raise RuntimeError("a recording is already open")
        self.rec = Recording(self._capacity)
        _RECORDING = self.rec
        _ON = True
        return self.rec

    def __exit__(self, *exc):
        global _ON, _RECORDING
        _ON = False
        _RECORDING = None
        self.rec.end_ns = time.perf_counter_ns()
        return False


def active_recording() -> Optional[Recording]:
    """The open recording, None when recording is off."""
    return _RECORDING


def report() -> str:
    """Text dump of every registered family."""
    return _factory.text_format()
