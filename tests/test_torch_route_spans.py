"""The round engine's element routing by spans (``core.exchange``'s
``_repack_sorted_spans`` and ``_route_elements_spans``, copied by
``kernels.ops.route_spans``) against the torch bodies it replaces on the
card (``_repack_sorted_torch``, ``_route_elements_torch``), bit for bit,
drop counts included.

On the CPU the span lists each wrapper builds go through the kernel's
plain version (``kernels.ref.route_spans_ref``) and through the kernel's
algorithm (``kernels.ref.pack_tile_walk_ref``, ragged last tile
included). Tests marked ``cuda`` run the kernel; on a machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_route_spans.py

This file imports no JAX, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace  # noqa: E402
from repro_torch.core import coalesce as t_co  # noqa: E402
from repro_torch.core import exchange as t_ex  # noqa: E402
from repro_torch.core import requests as t_rq  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import pack as t_pack  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402

PAD = t_rq.PAD_OFFSET
TILE = t_ref.TILE
# (dtype, the signed integers of its width): payloads are random bits, so
# the floating types carry NaNs with payloads and both signs of zero
DTYPES = [(torch.uint8, torch.uint8), (torch.bfloat16, torch.int16),
          (torch.float16, torch.int16), (torch.float32, torch.int32),
          (torch.int32, torch.int32), (torch.float64, torch.int64)]
DTYPE_IDS = [str(d).split(".")[-1] for d, _ in DTYPES]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run with `-m cuda` on the card")
    return torch.device("cuda", 0)


def _bits(x):
    """The tensor's bits as signed integers of its width, on the CPU."""
    x = x.cpu()
    if x.dtype.is_floating_point:
        return x.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                       8: torch.int64}[x.element_size()])
    return x


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.shape, b.shape)
    assert torch.equal(_bits(a), _bits(b))


def _payload(rng, shape, dtype, ints):
    """Random bits of ``dtype``'s width, viewed as ``dtype``."""
    info = np.iinfo({torch.uint8: np.uint8, torch.int16: np.int16,
                     torch.int32: np.int32,
                     torch.int64: np.int64}[ints])
    raw = rng.integers(info.min, info.max, size=shape, dtype=info.dtype,
                       endpoint=True)
    return torch.from_numpy(raw).view(dtype)


def _requests(rng, rows, cap, max_len, zero_share=0.2):
    """Offset-sorted requests a row: disjoint, with gaps, some of length
    0, a random count and the PAD_OFFSET / 0 tail."""
    O = np.full((rows, cap), PAD, np.int32)
    L = np.zeros((rows, cap), np.int32)
    C = rng.integers(0, cap + 1, size=rows).astype(np.int32)
    C[0] = cap
    for i in range(rows):
        n = int(C[i])
        ln = rng.integers(1, max_len + 1, size=n)
        ln[rng.random(n) < zero_share] = 0
        gaps = rng.integers(0, 4, size=n)
        O[i, :n] = np.cumsum(gaps) + np.concatenate([[0], np.cumsum(ln)[:-1]])
        L[i, :n] = ln
    return t_rq.RequestList(torch.from_numpy(O), torch.from_numpy(L),
                            torch.from_numpy(C))


def _to(r, dev):
    return t_rq.RequestList(r.offsets.to(dev), r.lengths.to(dev),
                            r.count.to(dev))


def _repack_case(rng, rows, cap, dcap, max_len, dtype, ints):
    """Sorted requests, payload starts anywhere in (and a little past)
    the payload row, and the payload."""
    r = _requests(rng, rows, cap, max_len)
    starts = torch.from_numpy(rng.integers(-3, dcap + 3, size=(rows, cap))
                              .astype(np.int32))
    return r, starts, _payload(rng, (rows, dcap), dtype, ints)


def _bucket_case(rng, rows, cap, in_dcap, max_len, n_dest, dtype, ints):
    """Sorted requests with packed payload starts, each sent to a random
    destination in [0, n_dest] (n_dest: kept in the list, routed
    nowhere), and a payload row that may be shorter than the lengths'
    sum."""
    r = _requests(rng, rows, cap, max_len)
    dest = torch.from_numpy(rng.integers(0, n_dest + 1, size=(rows, cap)))
    return (r, t_co.request_starts(r),
            _payload(rng, (rows, in_dcap), dtype, ints), dest)


def _walk_model(offsets, lengths, sources, data, out_len):
    """``ops.route_spans`` computed by the kernel's algorithm (the tile
    walk at base 0), on the payload's bits."""
    lead, cap = offsets.shape[:-1], offsets.shape[-1]
    bits = _bits(data)
    win, _ = t_ref.pack_tile_walk_ref(
        offsets.reshape(-1, cap), lengths.reshape(-1, cap),
        sources.reshape(-1, cap), bits.reshape(-1, bits.shape[-1]), 0,
        out_len)
    return win.view(data.dtype).reshape(*lead, out_len)


@pytest.fixture(params=["plain", "walk"])
def span_model(request, monkeypatch):
    """Take the span path on the CPU: the span list of each call goes
    through the kernel's plain version or through its tile walk."""
    monkeypatch.setattr(t_ex, "_routes_on_kernel", lambda *_: True)
    if request.param == "walk":
        monkeypatch.setattr(t_ops, "route_spans", _walk_model)
    return request.param


def _buckets_equal(a, b):
    for f in a._fields:
        _same(getattr(a, f), getattr(b, f))


# ------------------------------------------------------------------ CPU

def _span_rows(rng, rows, cap, out_len, dcap):
    """Rows of spans sorted by offset, in [0, out_len] with repeats
    (zero-length spans among them), lengths that may run past the next
    span or the row's end, sources a little outside the payload row; and
    one row with no span at all."""
    at = np.sort(rng.integers(0, out_len + 1, size=(rows, cap)), axis=1)
    n = rng.integers(0, 2 * max(out_len // cap, 1) + 2, size=(rows, cap))
    n[rng.random((rows, cap)) < 0.2] = 0
    n[-1] = 0
    src = rng.integers(-5, dcap + 5, size=(rows, cap))
    return [torch.from_numpy(x.astype(np.int32)) for x in (at, n, src)]


@pytest.mark.parametrize("out_len", [1, TILE - 1, TILE, TILE + 1, 9001])
def test_tile_walk_equals_plain_on_ragged_rows(out_len):
    """The tile walk, with its ragged last tile, equals the plain span
    copy: the last span that starts at or before a position decides it,
    as in the kernel."""
    rng = np.random.default_rng(out_len)
    spans = _span_rows(rng, 3, 64, out_len, 500)
    data = _payload(rng, (3, 500), torch.float64, torch.int64)
    _same(_walk_model(*spans, data, out_len),
          t_ref.route_spans_ref(*spans, data, out_len))


@pytest.mark.parametrize("dtype,ints", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("out_cap", [700, TILE + 5])
def test_repack_spans_equal_the_torch_body(span_model, dtype, ints, out_cap):
    """``repack_sorted``'s spans give its torch body, bit for bit:
    zero-length requests, the PAD tail, lengths summing past ``out_cap``
    and starts clamped into the payload row."""
    rng = np.random.default_rng(out_cap)
    r, starts, data = _repack_case(rng, 5, 96, 300, 40, dtype, ints)
    want = t_ex._repack_sorted_torch(r, starts, data, out_cap)
    _same(t_ex.repack_sorted(r, starts, data, out_cap), want)


@pytest.mark.parametrize("dtype,ints", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("caps", [(3, 64, 2000, 5000), (4, 5, 30, 3000),
                                  (2, 64, 2100, 900)],
                         ids=["roomy", "tight", "short_payload"])
def test_bucket_spans_equal_the_torch_body(span_model, dtype, ints, caps):
    """``bucket_by_dest``'s element spans give its torch body, bit for
    bit, and the same drop counts: buckets that overflow ``req_cap`` and
    ``data_cap``, requests kept but routed nowhere, and a payload row
    shorter than the lengths' sum."""
    n_dest, req_cap, data_cap, in_dcap = caps
    rng = np.random.default_rng(data_cap)
    r, starts, data, dest = _bucket_case(rng, 4, 128, in_dcap, 40, n_dest,
                                         dtype, ints)
    got = t_ex.bucket_by_dest(r, starts, data, dest, n_dest, req_cap,
                              data_cap)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_ex, "_routes_on_kernel", lambda *_: False)
        want = t_ex.bucket_by_dest(r, starts, data, dest, n_dest, req_cap,
                                   data_cap)
    if caps[1] == 5:
        assert int(want.dropped_requests.sum()) > 0
        assert int(want.dropped_elems.sum()) > 0
    _buckets_equal(got, want)


def _small_write(method, device, depth=1):
    from repro_torch.core import (IOConfig, RankMesh, contiguous_layout,
                                  make_tam_write, make_twophase_write)
    from repro_torch.io_patterns.generators import btio_write_pattern
    O, L, C, D = btio_write_pattern(16, 64, 4, 8, seed=3)
    layout = contiguous_layout(4 * 64 * 64 * 8, 4)
    cfg = IOConfig(req_cap=O.shape[1], data_cap=D.shape[1],
                   coalesce_cap=64, cb_buffer_size=4096,
                   kernel_fusion="fused_round", pipeline=depth > 1,
                   pipeline_depth=depth)
    if method == "tam":
        return make_tam_write(RankMesh(4, 1, 4), layout, cfg,
                              use_kernels=device.type == "cuda",
                              device=device)(O, L, C, D)
    return make_twophase_write(RankMesh(4, 1, 4), layout, cfg,
                               device=device)(O, L, C, D)


@pytest.mark.parametrize("method", ["tam", "twophase"])
def test_span_write_equals_torch_write_on_cpu(method, monkeypatch):
    """A small BTIO write with every routing call on spans (through the
    plain version) equals the same write with the torch bodies: file and
    every stats key. ``route_kernel_slots`` counts every routed slot on
    the span path and none on the CPU's own."""
    cpu = torch.device("cpu")
    trace.reset_counters()
    f_want, s_want = _small_write(method, cpu)
    counts = trace.counters()
    assert counts["route_slots"] > 0
    assert counts.get("route_kernel_slots", 0) == 0
    monkeypatch.setattr(t_ex, "_routes_on_kernel", lambda *_: True)
    trace.reset_counters()
    f_got, s_got = _small_write(method, cpu)
    counts = trace.counters()
    assert counts["route_kernel_slots"] == counts["route_slots"]
    _same(f_got, f_want)
    assert s_got.keys() == s_want.keys()
    for k in s_want:
        _same(s_got[k], s_want[k])


def test_cpu_tensors_keep_the_torch_bodies():
    """On the CPU the routing never builds spans: ``route_kernel_slots``
    stays 0 and ``route_spans`` launches nothing."""
    rng = np.random.default_rng(5)
    trace.reset_counters()
    before = t_pack.route_spans.launches
    r, starts, data = _repack_case(rng, 2, 16, 50, 8, torch.float32,
                                   torch.int32)
    t_ex.repack_sorted(r, starts, data, 60)
    r, starts, data, dest = _bucket_case(rng, 2, 16, 80, 8, 3,
                                         torch.float32, torch.int32)
    t_ex.bucket_by_dest(r, starts, data, dest, 3, 16, 40)
    assert trace.counters().get("route_kernel_slots", 0) == 0
    assert trace.counters()["route_slots"] == 2 * 60 + 2 * 80
    assert t_pack.route_spans.launches == before


class _CardShape:
    """What ``_routes_on_kernel`` reads of a payload (its device), with
    the shape and element size of a card tensor too large to make here."""

    def __init__(self, shape, item=8, device="cuda"):
        self.shape, self._item = shape, item
        self.device = torch.device(device)

    def element_size(self):
        return self._item


@pytest.mark.parametrize("shape,item,device,out_len,want", [
    ((16, 21296640), 8, "cuda", 16 * 2122416, True),
    ((16, 21296640), 8, "cpu", 16 * 2122416, False),
    ((16, 21296640), 16, "cuda", 100, False),
    ((2, 2**31), 1, "cuda", 100, False),
    ((2, 100), 1, "cuda", 2**31, False),
    ((2, 0), 4, "cuda", 100, False)])
def test_routes_on_kernel_needs_card_rows_that_fit_int32(shape, item, device,
                                                          out_len, want):
    """Every card payload takes the kernel; one whose rows the kernel
    cannot take (``want`` False on the card: positions past int32, an
    empty row, 16-byte elements) is refused by ``route_spans`` before
    anything runs, never walked slot by slot."""
    on_card = device == "cuda"
    assert t_ex._routes_on_kernel(_CardShape(shape, item, device)) \
        is on_card
    if not on_card or want:
        return
    meta = torch.device("meta")
    dtype = {1: torch.uint8, 4: torch.float32, 16: torch.complex128}[item]
    spans = torch.empty((shape[0], 4), dtype=torch.int32, device=meta)
    data = torch.empty(shape, dtype=dtype, device=meta)
    before = t_pack.route_spans.launches
    with pytest.raises((ValueError, TypeError)):
        t_pack.route_spans(spans, spans, spans, data, out_len)
    assert t_pack.route_spans.launches == before


def test_repack_spans_take_starts_of_any_integer_type(span_model):
    """int64 starts far outside int32 (the span path clamps them into
    ``[-2^31, dcap]`` before the kernel's int32) give the torch body's
    elements."""
    rng = np.random.default_rng(11)
    r, starts, data = _repack_case(rng, 4, 64, 200, 12, torch.float64,
                                   torch.int64)
    starts = starts.to(torch.int64)
    starts[:, ::3] += 3 * 2**31
    starts[:, 1::3] -= 3 * 2**31
    want = t_ex._repack_sorted_torch(r, starts, data, 500)
    _same(t_ex.repack_sorted(r, starts, data, 500), want)


@pytest.mark.parametrize("method", ["tam", "twophase"])
def test_every_bucketing_gets_packed_starts(method, monkeypatch):
    """``bucket_by_dest``'s span path needs each request's payload at its
    packed position: every call of a small write passes
    ``request_starts`` of its requests."""
    seen = []
    bucket = t_ex.bucket_by_dest

    def watched(r, starts, *a):
        seen.append(torch.equal(starts, t_co.request_starts(r)))
        return bucket(r, starts, *a)

    from repro_torch.core import rounds
    monkeypatch.setattr(rounds, "bucket_by_dest", watched)
    _small_write(method, torch.device("cpu"))
    assert seen and all(seen)


def test_route_spans_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        t_pack.route_spans(x, x, x[:1], x, 10)
    with pytest.raises(ValueError):
        t_pack.route_spans(x, x, x, x, 2**31)
    with pytest.raises(ValueError):
        t_pack.route_spans(x, x, x, x[:, :0], 10)


# ----------------------------------------------------------------- card

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ints", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("out_len", [1, TILE - 1, TILE, 3 * TILE + 7])
def test_cuda_route_spans_equals_plain(cuda, dtype, ints, out_len):
    """The kernel equals its plain version on spans with zero-length
    ones, spans past the next one or the row's end, clamped sources, and
    a row with no span at all."""
    rng = np.random.default_rng(out_len)
    rows, cap, dcap = 6, 256, 3 * TILE
    spans = _span_rows(rng, rows, cap, out_len, dcap)
    data = _payload(rng, (rows, dcap), dtype, ints)
    want = t_ref.route_spans_ref(*spans, data, out_len)
    before = t_pack.route_spans.launches
    got = t_pack.route_spans(*[a.to(cuda) for a in spans], data.to(cuda),
                             out_len)
    torch.cuda.synchronize()
    assert t_pack.route_spans.launches == before + 1
    _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ints", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("out_cap", [700, 2 * TILE + 5])
def test_cuda_repack_sorted_equals_the_torch_body(cuda, dtype, ints,
                                                  out_cap):
    rng = np.random.default_rng(out_cap + 1)
    r, starts, data = _repack_case(rng, 7, 300, 3000, 40, dtype, ints)
    r, starts, data = _to(r, cuda), starts.to(cuda), data.to(cuda)
    trace.reset_counters()
    before = t_pack.route_spans.launches
    got = t_ex.repack_sorted(r, starts, data, out_cap)
    assert t_pack.route_spans.launches == before + 1
    assert trace.counters()["route_kernel_slots"] == 7 * out_cap
    _same(got, t_ex._repack_sorted_torch(r, starts, data, out_cap))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ints", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("caps", [(3, 256, 5000, 12000), (4, 5, 30, 3000),
                                  (2, 256, 5100, 2000)],
                         ids=["roomy", "tight", "short_payload"])
def test_cuda_bucket_by_dest_equals_the_torch_body(cuda, dtype, ints, caps,
                                                   monkeypatch):
    n_dest, req_cap, data_cap, in_dcap = caps
    rng = np.random.default_rng(data_cap + 1)
    r, starts, data, dest = _bucket_case(rng, 5, 400, in_dcap, 40, n_dest,
                                         dtype, ints)
    r, starts, data, dest = (_to(r, cuda), starts.to(cuda), data.to(cuda),
                             dest.to(cuda))
    before = t_pack.route_spans.launches
    got = t_ex.bucket_by_dest(r, starts, data, dest, n_dest, req_cap,
                              data_cap)
    assert t_pack.route_spans.launches == before + 1
    monkeypatch.setattr(t_ex, "_routes_on_kernel", lambda *_: False)
    want = t_ex.bucket_by_dest(r, starts, data, dest, n_dest, req_cap,
                               data_cap)
    if req_cap == 5:
        assert int(want.dropped_requests.sum()) > 0
        assert int(want.dropped_elems.sum()) > 0
    _buckets_equal(got, want)


def _deployment_rows(rng, rows, width, n_dest, live=0.1):
    """BTIO-like rows: requests of 60 or 65 elements, in order, filling
    about ``live`` of ``width`` (a tenth: a round's live share), and a
    destination a request by its place in the row."""
    n = int(width * live) // 62
    ln = np.where(rng.random((rows, n)) < 0.5, 60, 65).astype(np.int32)
    o = (np.cumsum(ln, axis=1) - ln).astype(np.int32) * 3
    r = t_rq.RequestList(torch.from_numpy(o), torch.from_numpy(ln),
                         torch.full((rows,), n, dtype=torch.int32))
    dest = torch.from_numpy(np.arange(n) * n_dest // n).expand(rows, n)
    return r, dest


@pytest.mark.cuda
@pytest.mark.parametrize("width", [332760, 21296640])
def test_cuda_repack_at_the_deployment_widths(cuda, width):
    """``repack_sorted`` at the TAM write's widths: each rank's window
    out of [., 332760] and stage 1's repack of [., 21296640], f64."""
    rng = np.random.default_rng(width)
    rows = 4 if width < 10**6 else 2
    r, _ = _deployment_rows(rng, rows, width, 1)
    starts = torch.from_numpy(rng.integers(
        0, width - 65, size=(rows, r.capacity)).astype(np.int32))
    data = _payload(rng, (rows, width), torch.float64, torch.int64)
    r, starts, data = _to(r, cuda), starts.to(cuda), data.to(cuda)
    got = t_ex.repack_sorted(r, starts, data, width)
    _same(got, t_ex._repack_sorted_torch(r, starts, data, width))


@pytest.mark.cuda
def test_cuda_bucket_at_the_deployment_width(cuda, monkeypatch):
    """``bucket_by_dest`` at stage 2's width: [., 21296640] f64 into 16
    buckets of 2122416, bucket 3 overflowing."""
    rng = np.random.default_rng(7)
    width, n_dest, data_cap = 21296640, 16, 2122416
    r, dest = _deployment_rows(rng, 2, width, n_dest, live=0.2)
    dest = dest.clone()
    dest[:, : dest.shape[1] * 2 // 3] = 3
    data = _payload(rng, (2, width), torch.float64, torch.int64)
    r, dest, data = _to(r, cuda), dest.to(cuda), data.to(cuda)
    starts = t_co.request_starts(r)
    got = t_ex.bucket_by_dest(r, starts, data, dest, n_dest, r.capacity,
                              data_cap)
    monkeypatch.setattr(t_ex, "_routes_on_kernel", lambda *_: False)
    want = t_ex.bucket_by_dest(r, starts, data, dest, n_dest, r.capacity,
                               data_cap)
    assert int(want.dropped_elems.sum()) > 0
    _buckets_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("method", ["tam", "twophase"])
def test_cuda_span_write_equals_torch_write(cuda, method, depth,
                                            monkeypatch):
    """A small BTIO write on the card with the span kernel equals the
    same write on the card with the torch bodies: file and every stats
    key; ``route_kernel_slots`` equals ``route_slots``."""
    trace.reset_counters()
    before = t_pack.route_spans.launches
    f_got, s_got = _small_write(method, cuda, depth)
    counts = trace.counters()
    assert counts["route_kernel_slots"] == counts["route_slots"]
    assert t_pack.route_spans.launches > before
    monkeypatch.setattr(t_ex, "_routes_on_kernel", lambda *_: False)
    trace.reset_counters()
    f_want, s_want = _small_write(method, cuda, depth)
    assert trace.counters().get("route_kernel_slots", 0) == 0
    _same(f_got, f_want)
    for k in s_want:
        _same(s_got[k], s_want[k])
