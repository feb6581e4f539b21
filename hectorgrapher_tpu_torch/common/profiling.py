"""Section timing into the process-wide metrics registry (counterpart of
section, global_factory and report in hectorgrapher_tpu/common/profiling.py;
its JAX device-trace helpers are not ported: torch.profiler takes their
place)."""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

from hectorgrapher_tpu_torch.metrics.metrics import GLOBAL_FACTORY, FamilyFactory

_factory = GLOBAL_FACTORY
_sections = _factory.new_histogram_family(
    "hg_section_seconds",
    "Wall time per instrumented section",
    boundaries=[1e-4, 3e-4, 1e-3, 3e-3, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0],
)
_lock = threading.Lock()
_metrics_cache: Dict[str, object] = {}


def global_factory() -> FamilyFactory:
    """The process-wide registry (ref: metrics/register.cc RegisterAllMetrics)."""
    return _factory


@contextlib.contextmanager
def section(name: str):
    """Time a code section into the hg_section_seconds histogram family,
    labelled section=name. Host wall time: device work still queued when
    the section ends is not in it."""
    with _lock:
        metric = _metrics_cache.get(name)
        if metric is None:
            metric = _sections.add({"section": name})
            _metrics_cache[name] = metric
    t0 = time.perf_counter()
    try:
        yield
    finally:
        metric.observe(time.perf_counter() - t0)


def report() -> str:
    """Text dump of every registered family."""
    return _factory.text_format()
