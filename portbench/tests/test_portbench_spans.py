"""The reduction of a trace by the program's spans, on made-up events,
and the counter metrics on the tiny cells on the CPU."""
import sys
import time

import pytest
import torch
from conftest import CELLS, tiny_spec

from portbench import harness, spans
from portbench.spans import OUTSIDE, reduce

W, R, S = "repro_torch.write", "repro_torch.route", "repro_torch.send"
MS = 1e-6                       # ms a ns
# a call [0, 100) with two children, route [10, 40) and send [40, 90)
SPANS = [(0, 100, W), (10, 40, R), (40, 90, S)]


def test_a_kernel_goes_to_the_span_open_at_its_launch():
    # launched inside route (at 30), run while send is open on the host
    table = reduce(0, 100, SPANS, {7: 30}, [(50, 60, "k", 7)])
    assert table[R]["busy_ms"] == pytest.approx(10 * MS)
    assert table[S]["busy_ms"] == 0
    assert table[W]["busy_ms"] == 0 and table[W]["total_ms"] == \
        pytest.approx(10 * MS)


def test_an_event_with_no_launching_call_is_outside():
    table = reduce(0, 100, SPANS, {}, [(50, 60, "k", 9)])
    assert table[OUTSIDE]["busy_ms"] == pytest.approx(10 * MS)


def test_self_times_and_the_outside_partition_the_busy_time():
    launches = {1: 5, 2: 15, 3: 45, 4: 95, 5: 200}
    dev = [(0, 20, "a", 1), (10, 30, "b", 2), (25, 50, "c", 3),
           (60, 70, "d", 4), (65, 80, "e", 5), (85, 99, "f", 3)]
    table = reduce(0, 100, SPANS, launches, dev)
    busy = sum(r["busy_ms"] for r in table.values())
    from portbench.tracing import _union_ns
    assert busy == pytest.approx(
        _union_ns([(s, t) for s, t, _, _ in dev]) * MS)
    # overlaps go to the event that started first
    assert table[W]["busy_ms"] == pytest.approx((20 + 10) * MS)
    assert table[R]["busy_ms"] == pytest.approx(10 * MS)
    assert table[S]["busy_ms"] == pytest.approx((20 + 14) * MS)
    assert table[OUTSIDE]["busy_ms"] == pytest.approx(10 * MS)
    assert table[W]["total_ms"] == pytest.approx((30 + 10 + 34) * MS)


def test_an_idle_gap_goes_to_the_innermost_span_at_its_midpoint():
    dev = [(0, 12, "a", 1), (38, 42, "b", 1), (80, 82, "c", 1)]
    table = reduce(0, 120, SPANS, {1: 1}, dev)
    # 12..38 mid 25 in route, 42..80 mid 61 in send, 82..120 mid 101
    # outside every span
    assert table[R]["idle_ms"] == pytest.approx(26 * MS)
    assert table[S]["idle_ms"] == pytest.approx(38 * MS)
    assert table[OUTSIDE]["idle_ms"] == pytest.approx(38 * MS)
    assert table[W]["idle_ms"] == 0


def test_calls_and_host_time_count_the_spans_in_the_window():
    more = SPANS + [(200, 260, W), (500, 600, W)]
    table = reduce(0, 300, more, {}, [])
    assert table[W]["calls"] == 2
    assert table[W]["host_ms"] == pytest.approx(160 * MS)


def test_only_the_programs_annotations_are_spans():
    from torch.profiler import ProfilerActivity, profile
    from portbench.tracing import WINDOW_MARK
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with torch.profiler.record_function(WINDOW_MARK):
        with torch.profiler.record_function("user.mark"):
            with torch.profiler.record_function("repro_torch.step"):
                torch.ones(4).add_(1)
    prof.stop()
    table = spans.from_profile(prof, WINDOW_MARK)
    # the window is one idle stretch on a machine with no card
    assert "repro_torch.step" in table
    assert set(table) <= {"repro_torch.step", OUTSIDE}
    assert table["repro_torch.step"]["calls"] == 1
    assert "repro_torch.step" in spans.format_table(table, 1)


class _Event:
    """A profiler event as ``kineto_results.events()`` gives it."""

    def __init__(self, s, t, name, corr, device="CPU", note=False):
        from torch.autograd import DeviceType
        self._v = (s, t, name, corr, getattr(DeviceType, device), note)

    def start_ns(self):
        return self._v[0]

    def end_ns(self):
        return self._v[1]

    def name(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_a_kernel_links_to_its_runtime_call_not_an_operator_of_its_id():
    from types import SimpleNamespace as NS
    from portbench.tracing import WINDOW_MARK
    events = [
        _Event(0, 100, WINDOW_MARK, 1, note=True),
        _Event(0, 100, W, 2, note=True), _Event(10, 40, R, 3, note=True),
        _Event(40, 90, S, 4, note=True),
        # operators and runtime calls number their ids apart: operator 7
        # runs in send, the runtime call 7 (a launch from outside any
        # operator) in route
        _Event(45, 50, "aten::add", 7), _Event(20, 21, "cudaLaunchKernel", 7),
        _Event(60, 70, "k", 7, device="CUDA"),
        _Event(60, 70, R, 8, device="CUDA", note=True)]
    prof = NS(profiler=NS(kineto_results=NS(events=lambda: events)))
    table = spans.from_profile(prof, WINDOW_MARK)
    assert table[R]["busy_ms"] == pytest.approx(10 * MS)
    assert table[S]["busy_ms"] == 0
    assert sum(r["busy_ms"] for r in table.values()) == pytest.approx(10 * MS)


COUNTED = {"btio.tam.write": {"route_Gslots.write": "route_slots",
                              "slow_hop_GB.write": "slow_hop_bytes"},
           "btio.read": {"route_Gslots.read": "route_slots"}}


@pytest.mark.parametrize("cell", CELLS)
def test_the_counter_metrics_read_one_call_of_the_counters(cell):
    from repro_torch import trace
    spec = tiny_spec(cell)
    cpu = torch.device("cpu")
    result, _ = harness.run(spec, 2**31 + 7, 0.2, True, cpu,
                            time.perf_counter())
    # the counters of one call, made directly
    cfg, traffic = spec.config, spec.traffic
    O, L, C, D, file_len = harness.make_inputs(cfg, 2**31 + 7, cpu)
    fn = harness.make_collective(cfg, traffic, O, D, file_len, cpu)
    last = D
    if traffic["direction"] == "read":
        from portbench import reference
        last = reference.scatter_file(O, L, C, D, file_len)
    trace.reset_counters()
    fn(O, L, C, last)
    counts = trace.counters()
    scale = {"Gslots": 1e9, "GB": 1e9}
    for metric, counter in COUNTED[cell].items():
        got = result["metrics"][metric]
        assert got["value"] * scale[got["unit"]] == \
            pytest.approx(counts[counter], rel=1e-12)


def test_a_program_without_counters_leaves_the_metrics_out(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    result, _ = harness.run(tiny_spec("btio.read"), 2**31 + 7, 0.2, True,
                            torch.device("cpu"), time.perf_counter())
    assert result["correct"]
    assert "route_Gslots.read" not in result["metrics"]
    assert "device_ops.read" not in result["metrics"]   # no card here
