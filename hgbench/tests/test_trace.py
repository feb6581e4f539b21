"""The reduction of a trace: device time, spans and what launched in them,
the idle gaps by host span."""

from hgbench.lib.trace import DeviceOp, Span, TraceData

MS = 1_000_000


def _trace():
    spans = [Span("hgbench.scan", "main", 0, 100 * MS), Span("hgbench.ct_solve", "main", 10 * MS, 60 * MS),
             Span("hgbench.ct_scan_block", "main", 20 * MS, 21 * MS), Span("hgbench.ct_scan_block", "main", 40 * MS, 41 * MS),
             Span("hgbench.pg_node", "other", 30 * MS, 90 * MS)]
    ops = [DeviceOp("k3", 22 * MS, 23 * MS, 1), DeviceOp("fill", 21 * MS, 22 * MS, 2),
           DeviceOp("k3", 42 * MS, 44 * MS, 3), DeviceOp("k5", 43 * MS, 50 * MS, 4),
           DeviceOp("Memcpy DtoH", 95 * MS, 96 * MS, 5)]
    launches = {1: ("main", 20_500_000), 2: ("main", 20_100_000), 3: ("main", 40_500_000), 4: ("other", 40_600_000),
                5: ("main", 94 * MS)}
    return TraceData.from_events(spans, ops, launches, window_s=0.1)


def test_busy_time_is_the_union_of_operations():
    t = _trace()
    assert t.busy_intervals() == [[21 * MS, 23 * MS], [42 * MS, 50 * MS], [95 * MS, 96 * MS]]
    assert abs(t.busy_s() - 0.011) < 1e-12
    assert [o.name for o in t.kernels()] == ["fill", "k3", "k3", "k5"]


def test_operations_belong_to_the_span_that_launched_them_on_its_thread():
    groups = {(s.start, tuple(o.name for o in ops)) for s, ops in _trace().ops_by_span("ct_scan_block")}
    # k5 launched at 40.6 ms inside the second span's time, but on the
    # worker's thread: not the span's.
    assert groups == {(20 * MS, ("fill", "k3")), (40 * MS, ("k3",))}


def test_idle_gaps_by_the_main_threads_innermost_span():
    bd = _trace().breakdown()
    gaps = dict(bd["idle_gaps"])
    assert abs(gaps["ct_solve"] - 0.019) < 1e-12  # 23 -> 42 ms, inside ct_solve
    assert abs(gaps["scan"] - 0.045) < 1e-12  # 50 -> 95 ms
    assert dict(bd["device_ops"])["k3"] == 0.003
