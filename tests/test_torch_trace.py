"""The port's spans and counters (``repro_torch.trace``): a no-op
without a profiler, outputs unchanged under one, the spans nested as the
round engine's steps are, and the counters equal to the products of
shapes reckoned here."""
import contextlib
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import trace  # noqa: E402
from repro_torch.core import (IOConfig, RankMesh,  # noqa: E402
                              contiguous_layout, make_tam_write,
                              make_twophase_read, make_twophase_write)
from repro_torch.io_patterns.generators import btio_write_pattern  # noqa: E402

# 16 ranks as (2 nodes, 2 local aggregators, 4 ranks each), a 2048-word
# file of 128 words a rank, 4 rounds of 256-word windows
O, L, C, D = btio_write_pattern(16, 8, 4, 8, seed=0)
FILE_LEN, CB, N, A, M = 2048, 256, 2, 2, 4
P, REQ_CAP, DATA_CAP = 16, O.shape[1], D.shape[1]
DL = FILE_LEN // N
ROUNDS = DL // CB
CCAP = 16
MESH = RankMesh(N, A, M)
LAYOUT = contiguous_layout(FILE_LEN, N)
CFG = IOConfig(req_cap=REQ_CAP, data_cap=DATA_CAP, coalesce_cap=CCAP,
               cb_buffer_size=CB)
I32, ELEM = 4, D.itemsize


def _collective(kind, **kw):
    if kind == "tam":
        return make_tam_write(MESH, LAYOUT, CFG, device="cpu", **kw)
    if kind == "twophase":
        return make_twophase_write(MESH, LAYOUT, CFG, device="cpu")
    return make_twophase_read(MESH, LAYOUT, CFG, device="cpu")


def _file():
    out, _ = _collective("twophase")(O, L, C, D)
    return out


def _call(kind, **kw):
    return _collective(kind, **kw)(O, L, C, _file() if kind == "read"
                                   else D)


def _spans(kind, **kw):
    """The program's spans of one call under a CPU profiler, in start
    order, each ``(name, depth)``."""
    fn = _collective(kind, **kw)
    last = _file() if kind == "read" else D
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(O, L, C, last)
    ev = sorted((e.start_ns(), -e.end_ns(), e.name())
                for e in prof.profiler.kineto_results.events()
                if e.is_user_annotation()
                and e.name().startswith("repro_torch."))
    out, ends = [], []
    for s, neg_t, name in ev:
        while ends and ends[-1] <= s:
            ends.pop()
        out.append((name.removeprefix("repro_torch."), len(ends)))
        ends.append(-neg_t)
    return out


def test_span_is_the_shared_no_op_without_a_profiler():
    assert trace.span("repro_torch.a") is trace.span("repro_torch.b")
    assert isinstance(trace.span("repro_torch.a"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(trace.span("repro_torch.a"),
                          torch.profiler.record_function)
    assert isinstance(trace.span("repro_torch.a"), contextlib.nullcontext)


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b, strict=True))
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("kind,kw", [("tam", {}),
                                     ("tam", {"use_kernels": True}),
                                     ("twophase", {}), ("read", {})],
                         ids=["tam", "tam-kernels", "twophase", "read"])
def test_outputs_are_the_same_bits_under_a_profiler(kind, kw):
    plain = _call(kind, **kw)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _call(kind, **kw)
    assert _same(plain, traced)


@pytest.mark.parametrize("kind", ["tam", "twophase"])
def test_write_spans_nest_as_the_rounds_run(kind):
    steps = (["select", "route", "intranode", "bucket", "send"]
             if kind == "tam" else ["select", "route", "bucket", "send"])
    one_round = ([("exchange", 1)] + [(s, 2) for s in steps]
                 + [("drain", 1)])
    assert _spans(kind) == [("write", 0)] + one_round * ROUNDS


def test_read_spans_nest_as_the_rounds_run():
    assert _spans("read") == [("read", 0)] + [("fetch", 1),
                                             ("scatter", 1)] * ROUNDS


def _counts(kind, **kw):
    trace.reset_counters()
    _collective(kind, **kw)(O, L, C, D)
    return trace.counters()


def test_tam_counters_are_products_of_shapes():
    rdcap = min(DATA_CAP, CB)                   # a rank's round payload
    m_cap = M * rdcap                           # a group's gathered payload
    groups = N * A
    # route: each rank's window out of its payload; stage 1's repack and
    # the buckets' element routing: each group's gathered payload
    slots = ROUNDS * (P * rdcap + 2 * groups * m_cap)
    # stage 2's buckets: the coalesced runs (cut to CCAP) split at most
    # m_cap // DL + 2 ways, their counts, and the payload wire
    req = min(CCAP * (m_cap // DL + 2), CB)
    wire = min(m_cap, CB)
    sent = ROUNDS * groups * N * (2 * req * I32 + I32 + wire * ELEM)
    for kw in ({}, {"use_kernels": True}):
        assert _counts("tam", **kw) == {"route_slots": slots,
                                        "slow_hop_bytes": sent}


def test_twophase_counters_are_products_of_shapes():
    split_cap = REQ_CAP * (DATA_CAP // CB + 2)
    req, dcap = min(split_cap, CB), min(DATA_CAP, CB)
    assert _counts("twophase") == {
        "route_slots": ROUNDS * 2 * P * DATA_CAP,
        "slow_hop_bytes": ROUNDS * P * N * (2 * req * I32 + I32
                                            + dcap * ELEM)}


def test_read_counters_are_products_of_shapes():
    f = _file()
    trace.reset_counters()
    _collective("read")(O, L, C, f)
    assert trace.counters() == {"route_slots": ROUNDS * P * DATA_CAP}


def test_counters_add_and_reset():
    trace.reset_counters()
    trace.count("x", 3)
    trace.count("x", 4)
    assert trace.counters() == {"x": 7}
    trace.reset_counters()
    assert trace.counters() == {}


def test_the_module_loads_no_jax():
    src = Path(__file__).resolve().parent.parent / "src"
    code = ("import sys, repro_torch.trace; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code],
                          env={"PYTHONPATH": str(src),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
