"""The trace reduction's arithmetic on made-up spans, and the span
wrappers on the CPU."""
import pytest
import torch

from portbench.tracing import DeviceTrace, Tracer, _union_ns


def test_union_counts_overlaps_once():
    assert _union_ns([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    assert _union_ns([]) == 0


def test_idle_gaps_go_to_the_innermost_host_operation():
    cpu = [(0, 100, "outer", 1), (10, 40, "inner", 2), (60, 70, "other", 3)]
    dev = [(0, 10, "k", 0), (40, 50, "k", 0), (80, 100, "k", 0)]
    gaps = dict(DeviceTrace._gaps(0, 120, cpu, dev))
    # 10..40 inside "inner", 50..80 mid 65 inside "other", 100..120 outside
    assert gaps == pytest.approx({"inner": 30e-9, "other": 30e-9,
                                  "host_outside_any_recorded_op": 20e-9})


def test_spans_of_arguments_and_attributes(monkeypatch):
    import types
    mod = types.ModuleType("portbench_fake_program")

    def engine(n, work, other=None):
        return [work(i) for i in range(n)]
    mod.engine, mod.leaf = engine, lambda x: x + 1
    monkeypatch.setitem(__import__("sys").modules, mod.__name__, mod)
    reader = types.SimpleNamespace(WRAPS=(
        f"{mod.__name__}.engine(work)", f"{mod.__name__}.leaf",
        f"{mod.__name__}.engine(absent)", f"{mod.__name__}.gone"))
    t = Tracer(torch, torch.device("cpu"), {"m": reader})
    t.install()
    assert mod.engine(3, mod.leaf) == [1, 2, 3]
    t.remove()
    assert mod.engine is engine
    assert len(t.span_ms(f"{mod.__name__}.engine(work)")) == 3
    assert len(t.span_ms(f"{mod.__name__}.leaf")) == 3
    assert t.span_ms(f"{mod.__name__}.engine(absent)") is None
    assert t.span_ms(f"{mod.__name__}.gone") is None
