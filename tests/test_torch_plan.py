"""The port's planner against the reference's: the 245 golden plans
field for field, the pass order under ``trace=True``, and
``plan_from_fields`` carrying a reference plan into the port."""
import json

import pytest

pytest.importorskip("torch")

from _golden_plans import (CASES, GOLDEN_PATH, LAYOUT, N_AGGREGATORS,  # noqa: E402
                           N_NODES, N_RANKS, case_key, compile_case,
                           serialize)

from repro_torch.core import domains as t_domains  # noqa: E402
from repro_torch.core import plan as t_plan  # noqa: E402

with open(GOLDEN_PATH) as _f:
    GOLDEN = json.load(_f)


def _compile_port(case: dict, **kw):
    cfg = t_plan.IOConfig(req_cap=8, data_cap=64, coalesce_cap=32,
                          cb_buffer_size=case["cb"],
                          pipeline=case["pipeline"],
                          pipeline_depth=case["pipeline_depth"],
                          slow_hop_codec=case["codec"],
                          placement=case["placement"])
    return t_plan.compile_plan(t_domains.FileLayout(**LAYOUT), cfg,
                               n_aggregators=N_AGGREGATORS, n_nodes=N_NODES,
                               n_ranks=N_RANKS, method=case["method"],
                               direction=case["direction"], **kw)


def test_golden_cases_all_present():
    assert len(CASES) == 245
    assert sorted(GOLDEN) == sorted(case_key(c) for c in CASES)


@pytest.mark.parametrize("case", CASES, ids=case_key)
def test_port_reproduces_golden_plan(case):
    got = serialize(_compile_port(case))
    assert got == GOLDEN[case_key(case)]


TRACE_CASES = [c for c in CASES
               if c["method"] == "auto" and c["cb"] == "auto"
               and c["codec"] in (None, "auto")][:6] + CASES[-2:]


@pytest.mark.parametrize("case", TRACE_CASES, ids=case_key)
def test_trace_matches_reference(case):
    """Same passes in the same order, and every intermediate snapshot
    equal field for field."""
    _, ref_trace = compile_case(case, trace=True)
    _, port_trace = _compile_port(case, trace=True)
    assert [n for n, _ in port_trace] == [n for n, _ in ref_trace]
    for (name, ref_snap), (_, port_snap) in zip(ref_trace, port_trace):
        assert serialize(port_snap) == serialize(ref_snap), name


@pytest.mark.parametrize("case", CASES[::20] + CASES[-1:], ids=case_key)
def test_plan_from_fields_round_trips_reference_plan(case):
    ref = compile_case(case)
    fields = dict(serialize(ref), transport=ref.transport)
    carried = t_plan.plan_from_fields(fields)
    assert carried == _compile_port(case)
    assert serialize(carried) == serialize(ref)
    assert carried.domain_len == ref.domain_len
    assert carried.in_flight_windows == ref.in_flight_windows
    assert t_plan.plan_diff(carried, _compile_port(case)) == ""
