"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (they need
``nvcc`` to build the kernels, and a card to run them). On a machine
with one, run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import requests as t_rq  # noqa: E402
from repro_torch.kernels import coalesce_kernel as t_ck  # noqa: E402
from repro_torch.kernels import fused_round as t_fr  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.kernels import sort as t_sort  # noqa: E402

PAD = t_rq.PAD_OFFSET


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def _coalesce_rows(rng, batch, n):
    offs = np.tile(np.arange(n, dtype=np.int32) * 4, (batch, 1))
    gaps = rng.random((batch, n)) < 0.3
    offs = offs + np.cumsum(gaps, axis=1).astype(np.int32) * 2
    lens = np.full((batch, n), 4, np.int32)
    return offs, lens


def _drain_list(rng, cap, n, base, dup=0):
    """An unsorted drain list: n disjoint requests at or after ``base``
    (the first ``dup`` repeated with identical payload), shuffled among
    PAD slots, with a payload stream covering every listed length."""
    gaps = rng.integers(1, 9, size=n)
    ln = rng.integers(1, 6, size=n).astype(np.int32)
    o = (np.cumsum(gaps) + np.concatenate([[0], np.cumsum(ln)[:-1]])
         + base).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(ln)[:-1]]).astype(np.int32)
    o, ln, starts = (np.concatenate([x, x[:dup]]) for x in (o, ln, starts))
    full = [np.full(cap, PAD, np.int32), np.zeros(cap, np.int32),
            np.zeros(cap, np.int32)]
    slots = rng.permutation(cap)[:len(o)]
    for f, x in zip(full, (o, ln, starts)):
        f[slots] = x
    data = rng.integers(1, 1 << 30, size=int(ln.sum()) + 7).astype(np.int32)
    return (*full, data)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run with `-m cuda` on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch", [(2, 1), (8, 3), (1024, 5), (8192, 64),
                                     (32768, 16)])
def test_cuda_bitonic_sort_equals_plain(cuda, n, batch):
    rng = np.random.default_rng(n)
    offs = rng.integers(0, 1000, size=(batch, n)).astype(np.int32)
    offs[:, ::3] = PAD
    args = [_t(offs).to(cuda)] + [
        _t(rng.integers(0, 1 << 30, size=(batch, n)).astype(np.int32)).to(cuda)
        for _ in range(2)]
    before = t_sort.bitonic_sort.launches
    got = t_sort.bitonic_sort(*args)
    assert t_sort.bitonic_sort.launches == before + 1
    for g, w in zip(got, t_ref.sort_ref(*args)):
        assert torch.equal(g, w)


INT32_MIN = -(1 << 31)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["extremes", "all_equal", "all_pad",
                                  "descending"])
@pytest.mark.parametrize("n", [4096, 8192, 32768])   # 1, 2 and 8 blocks
@pytest.mark.parametrize("batch", [1, 16])
def test_cuda_bitonic_sort_edge_keys(cuda, case, n, batch):
    """Keys INT32_MIN, -1, 0 and PAD_OFFSET; all-equal keys (the carries
    keep their order: stability); all-padding rows; a descending row."""
    rng = np.random.default_rng(n + batch)
    if case == "extremes":
        offs = rng.choice(np.asarray([INT32_MIN, -1, 0, PAD], np.int64),
                          size=(batch, n)).astype(np.int32)
    elif case == "all_equal":
        offs = np.full((batch, n), -1, np.int32)
    elif case == "all_pad":
        offs = np.full((batch, n), PAD, np.int32)
    else:
        offs = np.tile(np.arange(n, 0, -1, dtype=np.int32) - n // 2,
                       (batch, 1))
    lens = np.tile(np.arange(n, dtype=np.int32), (batch, 1))
    carry = rng.integers(INT32_MIN, 1 << 31, size=(batch, n),
                         dtype=np.int64).astype(np.int32)
    args = [_t(x).to(cuda) for x in (offs, lens, carry)]
    got = t_sort.bitonic_sort(*args)
    for g, w in zip(got, t_ref.sort_ref(*args)):
        assert torch.equal(g, w)
    if case in ("all_equal", "all_pad"):
        assert torch.equal(got[1], args[1])


@pytest.mark.cuda
def test_cuda_fused_sort_pack_at_the_tam_drain_shape(cuda):
    """[16, 32768] lists (the TAM drain's, eight sort blocks a row) into
    [16, 262144] windows: window and mask equal the plain version."""
    rng = np.random.default_rng(16)
    rows = [_drain_list(rng, 32768, 6000, 262144 * (i + 1), dup=i)
            for i in range(16)]
    dcap = max(r[3].size for r in rows)
    data = np.stack([np.pad(r[3], (0, dcap - r[3].size)) for r in rows])
    args = [_t(np.stack([r[k] for r in rows])).to(cuda) for k in range(3)]
    d = _t(data).to(cuda)
    bases = torch.tensor([262144 * (i + 1) for i in range(16)],
                         dtype=torch.int32, device=cuda)
    before = t_fr.fused_sort_pack.launches
    got = t_fr.fused_sort_pack(*args, d, bases, 262144)
    assert t_fr.fused_sort_pack.launches == before + 1
    want = t_ref.fused_sort_pack_ref(*args, d, bases, 262144)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1].sum()) > 0


# rows whose ends wrap past 2^31 - 1 (the reference adds off + ln in
# int32): a run merged through the wrap; a pad's run that takes in a
# non-pad entry through the wrap and so has no head, then a later head
# dropped past the run count; the same without the later head
WRAP_ROWS = [
    ([0, 4, 2147483640, -2147483646, PAD, PAD, PAD, PAD],
     [4, 4, 10, 3, 0, 0, 0, 0]),
    ([0, 4, PAD, -2147483647, 100, PAD, PAD, PAD], [4, 4, 2, 3, 4, 0, 0, 0]),
    ([0, 4, PAD, -2147483647, PAD, PAD, PAD, PAD], [4, 4, 2, 3, 0, 0, 0, 0]),
]


def _coalesce_case(rng, case, batch, n):
    """Offset-sorted ``[batch, n]`` rows (the CPU model's cases in
    ``test_torch_coalesce_tiles.py``): ``tail`` the rows of
    :func:`_coalesce_rows` with a fifth of padding at the tail and two
    pads inside the first row; ``long_runs`` runs across
    tile edges; ``all_pad`` whole tiles of padding and a row of padding
    only; ``interspersed`` pads inside the live part (later heads fall
    past the run count); ``neg_start`` off[0] == -1 (run id -1);
    ``wrap`` the rows whose ends wrap, tiled to n."""
    if case == "wrap":
        reps = -(-batch * n // 24)
        return tuple(np.tile(np.array(x, np.int32).ravel(), reps)
                     [:batch * n].reshape(batch, n) for x in zip(*WRAP_ROWS))
    live = {"all_pad": min(n, 300), "long_runs": n - 50}.get(case,
                                                             n - n // 5)
    if case == "tail":
        offs, lens = _coalesce_rows(rng, batch, n)
        offs[:, live:], lens[:, live:] = PAD, 0
        if n > 20:
            offs[0, 10:12], lens[0, 10:12] = PAD, 0
        return offs, lens
    p_gap = {"long_runs": 0.0002, "neg_start": 0.01}.get(case, 0.3)
    lens = rng.integers(1, 7, size=(batch, n)).astype(np.int64)
    gaps = (rng.random((batch, n)) < p_gap) * rng.integers(1, 9, (batch, n))
    offs = np.cumsum(lens + gaps, axis=1) - lens + 1000
    offs[:, live:], lens[:, live:] = PAD, 0
    if case == "all_pad":
        offs[-1], lens[-1] = PAD, 0
    if case == "interspersed":
        at = rng.random(offs.shape) < 0.05
        at[:, live:] = False
        offs[at], lens[at] = PAD, 0
    if case == "neg_start":
        offs[:, 0], lens[:, 0] = -1, offs[:, 1] + 1
    return offs.astype(np.int32), lens.astype(np.int32)


def _pads_to_tail(offs, lens):
    """Each row's padding moved behind its live entries, in order."""
    order = np.argsort(offs == PAD, axis=1, kind="stable")
    return (np.take_along_axis(offs, order, 1),
            np.take_along_axis(lens, order, 1))


def _long_coalesce_case(rng, case, rows, n):
    """Rows longer than the kernel's block for ``ops.coalesce``, padding
    at the tail only: ``_coalesce_case``'s cases with their pads moved
    to the tail; ``few_runs`` one run a row across a block edge, the
    rest padding; ``many_runs`` more runs than one block holds, none
    merging; ``edges`` as many runs, merging only across the block
    edges of a row."""
    if case in ("few_runs", "many_runs", "edges"):
        offs = np.full((rows, n), PAD, np.int32)
        lens = np.zeros((rows, n), np.int32)
        live = 40000 if case == "few_runs" else n - n // 4
        step = 3 if case == "few_runs" else 3 + rng.integers(0, 2, n)
        offs[:, :live] = np.cumsum(np.broadcast_to(step, (n,)))[:live] - 3
        lens[:, :live] = 3 if case == "few_runs" else 2
        if case == "few_runs":
            offs[1, 20000:40000] += 1
        if case == "edges":
            block = t_ck.MAX_BLOCK
            ends = np.arange(block - 1, live - 1, block)
            lens[:, ends] = offs[0, ends + 1] - offs[0, ends]
        return offs, lens
    return _pads_to_tail(*_coalesce_case(rng, case, rows, n))


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch,case", [
    (8, 1, "tail"), (100, 3, "tail"), (4096, 7, "tail"),
    (32768, 16, "tail"), (4097, 1, "tail"), (12289, 200, "tail"),
    (32767, 3, "tail"), (32768, 1, "long_runs"), (32768, 200, "tail"),
    (32768, 200, "interspersed"), (24576, 16, "all_pad"),
    (9000, 5, "interspersed"), (4100, 2, "neg_start"),
    (12288, 3, "long_runs"), (8, 3, "wrap"), (32768, 16, "wrap"),
    (4101, 2, "wrap")])
def test_cuda_coalesce_equals_plain(cuda, n, batch, case):
    """Every case at one to eight tiles a row; 200 rows of 8 tiles are
    more clusters than the card holds at once."""
    rng = np.random.default_rng(n)
    offs, lens = _coalesce_case(rng, case, batch, n)
    o, ln = _t(offs).to(cuda), _t(lens).to(cuda)
    for g, w in zip(t_ck.coalesce(o, ln), t_ref.coalesce_ref(o, ln)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_coalesce_unaligned_rows(cuda):
    """Rows that do not start on 16 bytes take element loads; the
    occupancy query answers."""
    offs, lens = _coalesce_case(np.random.default_rng(9), "tail", 5, 8192)
    o = torch.empty(offs.size + 1, dtype=torch.int32, device=cuda)
    ln = torch.empty(offs.size + 1, dtype=torch.int32, device=cuda)
    o, ln = o[1:].view(5, 8192), ln[1:].view(5, 8192)
    o.copy_(_t(offs)), ln.copy_(_t(lens))
    assert o.data_ptr() % 16 and o.is_contiguous()
    for g, w in zip(t_ck.coalesce(o, ln), t_ref.coalesce_ref(o, ln)):
        assert torch.equal(g, w)
    assert t_ck.max_active_clusters(32768) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.uint8,
                                   torch.int16, torch.int64])
def test_cuda_fused_sort_pack_equals_plain(cuda, dtype):
    rng = np.random.default_rng(3)
    rows = [_drain_list(rng, 2048, 400, 8192 * (i + 1), dup=i)
            for i in range(4)]
    dcap = max(r[3].size for r in rows)
    data = np.stack([np.pad(r[3], (0, dcap - r[3].size)) for r in rows])
    args = [_t(np.stack([r[k] for r in rows])).to(cuda) for k in range(3)]
    d = _t(data % 200).to(cuda).to(dtype)
    bases = torch.tensor([8192 * (i + 1) for i in range(4)],
                         dtype=torch.int32, device=cuda)
    got = t_fr.fused_sort_pack(*args, d, bases, 8192)
    want = t_ref.fused_sort_pack_ref(*args, d, bases, 8192)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((2, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        t_sort.bitonic_sort(x, x, x.to(torch.int64))
    with pytest.raises(ValueError):
        t_ck.coalesce(x.t().contiguous().t()[:, :32], x[:, :32])


def _zero_skip_rows(rng, rows, n, dtype):
    """About half zeros, an all-zero and a no-zero row; float rows also
    hold -0.0 (a zero) and NaN (a nonzero)."""
    x = rng.integers(-5, 6, size=(rows, n)) * (rng.random((rows, n)) < 0.5)
    x = x.astype(np.float32 if dtype == torch.float32 else np.int32)
    x[0] = 0
    x[1] = np.where(x[1] == 0, 3, x[1])
    if dtype == torch.float32 and rows > 2:
        x = x * np.float32(0.75)
        x[2, ::3] = np.float32(-0.0)
        x[2, 1::7] = np.nan
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("rows,n", [(2, 1), (3, 8), (5, 100), (4, 4096),
                                    (3, 5000), (16, 262144)])
def test_cuda_zero_skip_equal_plain(cuda, dtype, rows, n):
    """Both kernels equal their plain versions bit for bit, through the
    ops wrappers that pad odd widths to a power of two."""
    from repro_torch.kernels import ops as t_ops
    x = _t(_zero_skip_rows(np.random.default_rng(n), rows, n, dtype)
           ).to(cuda)
    before = (t_fr.zero_skip_encode.launches,
              t_fr.zero_skip_decode.launches)
    vals, pos = t_ops.rle_zero_skip_encode(x)
    out = t_ops.rle_zero_skip_decode((vals, pos))
    assert (t_fr.zero_skip_encode.launches,
            t_fr.zero_skip_decode.launches) == (before[0] + 1, before[1] + 1)
    n2 = 1 << max(n - 1, 1).bit_length()
    padded = torch.nn.functional.pad(x, (0, n2 - n))
    wv, wp = t_ref.zero_skip_encode_ref(padded)
    assert torch.equal(vals.view(torch.int32), wv[:, :n].view(torch.int32))
    assert torch.equal(pos, wp[:, :n])
    want = t_ref.zero_skip_decode_ref(wv, wp)[:, :n]
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_cuda_zero_skip_decode_of_scattered_positions(cuda):
    """decode takes any order of positions, not only the encoder's."""
    rng = np.random.default_rng(9)
    n = 1024
    pos = np.stack([rng.permutation(n) for _ in range(3)]).astype(np.int32)
    pos[:, ::5] = -1
    vals = rng.integers(1, 1 << 30, size=(3, n)).astype(np.int32)
    v, p = _t(vals).to(cuda), _t(pos).to(cuda)
    assert torch.equal(t_fr.zero_skip_decode(v, p),
                       t_ref.zero_skip_decode_ref(v, p))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_absent", "dense", "many_tiles",
                                  "short_rows", "float_bits", "unaligned"])
def test_cuda_zero_skip_decode_cases(cuda, case):
    """Rows with no position (all -1), fully dense rows, rows spanning
    many of the scatter's 4096-entry tiles, rows shorter than one tile
    (several rows a tile), float32 -0.0 and NaN payloads moved as bits,
    and (vals, pos) views that do not start on 16 bytes; positions in
    any order, some negative (dropped)."""
    rng = np.random.default_rng(len(case))
    rows, n = {"many_tiles": (3, 65536), "short_rows": (37, 16)}.get(
        case, (5, 8192))
    pos = np.stack([rng.permutation(n) for _ in range(rows)]).astype(
        np.int32)
    if case == "all_absent":
        pos[:] = -1
    elif case != "dense":
        drop = rng.random((rows, n)) < 0.4
        pos[drop] = rng.choice([-1, -7, INT32_MIN], size=int(drop.sum()))
    vals = rng.integers(INT32_MIN, 1 << 31, size=(rows, n),
                        dtype=np.int64).astype(np.int32)
    if case == "float_bits":
        f = vals.view(np.float32)
        f[:, ::3] = np.float32(-0.0)
        f[:, 1::5] = np.nan
    v, p = _t(vals).to(cuda), _t(pos).to(cuda)
    if case == "float_bits":
        v = v.view(torch.float32)
    if case == "unaligned":
        v = torch.cat([v.reshape(-1), v.reshape(-1)[:1]])[1:].reshape(
            rows, n)
        p = torch.cat([p.reshape(-1)[:3], p.reshape(-1)])[3:].reshape(
            rows, n)
        assert v.data_ptr() % 16 and p.data_ptr() % 16
    before = t_fr.zero_skip_decode.launches
    got = t_fr.zero_skip_decode(v, p)
    assert t_fr.zero_skip_decode.launches == before + 1
    want = t_ref.zero_skip_decode_ref(v, p)
    assert got.dtype == v.dtype
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if case == "all_absent":
        assert not bool(got.view(torch.int32).any())
    if case == "dense":
        assert torch.equal(got.view(torch.int32).sort(1).values,
                           v.view(torch.int32).sort(1).values)


ZERO_SKIP_DTYPES = [torch.uint8, torch.bool, torch.int8, torch.int16,
                    torch.float16, torch.bfloat16, torch.int32, torch.float32,
                    torch.int64, torch.float64]


def _rows_of(x, dtype, cuda):
    """numpy rows as ``dtype`` on the card: bool as x != 0, the rest by
    value (floats with their -0.0 and NaN)."""
    t = _t(x).to(cuda)
    if dtype == torch.bool:
        return t != 0
    return t.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ZERO_SKIP_DTYPES, ids=str)
@pytest.mark.parametrize("rows,n", [(2, 1), (3, 8), (5, 100), (3, 5000),
                                    (16, 262144), (1100, 8192)])
def test_cuda_zero_skip_every_width_equals_plain(cuda, dtype, rows, n):
    """Both kernels at every element width (1, 2, 4, 8 bytes), integer
    and float zero tests, bit for bit against their plain versions: rows
    shorter than a tile, rows of many chunks chained by the look-back
    ([16, 262144]: 64 chunks a row) and rows of one CTA each (1100 rows,
    more than the card's SMs); -0.0 is a zero and NaN is not."""
    from repro_torch.kernels import ops as t_ops
    floats = dtype.is_floating_point
    x = _zero_skip_rows(np.random.default_rng(n + rows), rows, n,
                        torch.float32 if floats else torch.int32)
    if floats:
        x[1, 1::4] = np.float32(-0.0)
    x = _rows_of(x, dtype, cuda)
    vals, pos = t_ops.rle_zero_skip_encode(x)
    n2 = 1 << max(n - 1, 1).bit_length()
    padded = torch.nn.functional.pad(x, (0, n2 - n))
    wv, wp = t_ref.zero_skip_encode_ref(padded)
    assert vals.dtype == dtype
    assert torch.equal(vals.view(torch.uint8), wv[:, :n].contiguous()
                       .view(torch.uint8))
    assert torch.equal(pos, wp[:, :n])
    out = t_ops.rle_zero_skip_decode((vals, pos))
    want = t_ref.zero_skip_decode_ref(wv, wp)[:, :n].contiguous()
    assert out.dtype == dtype
    assert torch.equal(out.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.cuda
def test_cuda_zero_skip_rejects_other_dtypes(cuda):
    """The kernels take 1-, 2-, 4- and 8-byte integers and bool and 2-,
    4- and 8-byte floats; complex (no bit test decides its zero) and the
    1-byte floats raise before any launch, and pos must be int32."""
    for dtype in (torch.complex64, torch.float8_e4m3fn):
        x = torch.zeros((2, 64), dtype=dtype, device=cuda)
        with pytest.raises(TypeError):
            t_fr.zero_skip_encode(x)
        with pytest.raises(TypeError):
            t_fr.zero_skip_decode(x, torch.zeros((2, 64), dtype=torch.int32,
                                                 device=cuda))
    x = torch.zeros((2, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        t_fr.zero_skip_decode(x, x.to(torch.int64))


def _walk_lists(rng, rows, cap, out_len, base, case):
    """Unsorted request lists (a third PAD_OFFSET) that the pack tile
    walk must take like the per-position search: ``nested`` (requests
    inside longer ones, equal offsets, zero lengths), ``wrap`` (offsets
    near 2^31 - 1 and -2^31 with a base whose tiles wrap), ``zero_len``,
    ``dense`` (many requests a tile, every offset repeated)."""
    n = cap - cap // 3
    offs = np.full((rows, cap), PAD, np.int64)
    lens = np.zeros((rows, cap), np.int64)
    for r in range(rows):
        b = base[r]
        if case == "nested":
            o = b + rng.integers(-300, out_len + 300, size=n)
            o[: n // 4] = o[n // 4: 2 * (n // 4)]
            ln = rng.integers(0, 3 * out_len // n + 400, size=n)
        elif case == "wrap":
            o = np.concatenate([
                rng.integers(PAD - 6000, PAD - 1, size=n // 2),
                rng.integers(INT32_MIN, INT32_MIN + 8192, size=n - n // 2)])
            ln = rng.integers(0, 40, size=n)
        elif case == "dense":
            o = b + np.repeat(rng.integers(0, out_len, size=n // 2), 2)
            o = np.concatenate([o, [b] * (n - o.size)])
            ln = rng.integers(0, 9, size=n)
        else:
            o = b + rng.integers(0, out_len, size=n)
            ln = np.zeros(n, np.int64)
        slots = rng.permutation(cap)[:n]
        offs[r, slots], lens[r, slots] = o, ln
    starts = rng.integers(0, 1 << 16, size=(rows, cap))
    return [x.astype(np.int32) for x in (offs, lens, starts)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nested", "wrap", "zero_len", "dense"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.uint8, torch.int64])
def test_cuda_fused_sort_pack_walk_cases(cuda, case, dtype):
    """The tile walk where it is easiest to get wrong: nested requests
    (only the last offset at or before p decides), equal offsets (the
    last in the stable order wins), zero lengths, many requests a tile,
    and bases whose tiles wrap past 2^31 - 1 (a per-position search
    there): equal to the walk's plain algorithm on the plain sort, whose
    equality with the per-position search the CPU tests hold."""
    rng = np.random.default_rng(len(case))
    rows, cap, out_len = 4, 2048, 16384
    base = ([(1 << 31) - 9000 + 3 * r for r in range(rows)] if case == "wrap"
            else [4096 * r - 77 for r in range(rows)])
    offs, lens, starts = (_t(x).to(cuda) for x in _walk_lists(
        rng, rows, cap, out_len, base, case))
    data = _t(rng.integers(1, 120, size=(rows, 1 << 16))).to(cuda).to(dtype)
    b = torch.tensor(base, dtype=torch.int32, device=cuda)
    got = t_fr.fused_sort_pack(offs, lens, starts, data, b, out_len)
    want = t_ref.pack_tile_walk_ref(*t_ref.sort_ref(offs, lens, starts),
                                    data, b, out_len)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)
    assert (int(got[1].sum()) == 0) == (case == "zero_len")


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["twophase", "tam"])
def test_cuda_write_equals_cpu_write(cuda, method):
    """A small BTIO write: file and every stats key on the card equal
    the same write on the CPU, and the file equals write_reference."""
    from repro_torch.core import (IOConfig, RankMesh, contiguous_layout,
                                  make_tam_write, make_twophase_write,
                                  write_reference)
    from repro_torch.io_patterns.generators import btio_write_pattern
    O, L, C, D = btio_write_pattern(16, 64, 4, 8, seed=3)
    layout = contiguous_layout(4 * 64 * 64 * 8, 4)
    cfg = IOConfig(req_cap=O.shape[1], data_cap=D.shape[1],
                   coalesce_cap=64, cb_buffer_size=4096,
                   kernel_fusion="fused_round")
    mk = make_twophase_write if method == "twophase" else make_tam_write
    kw = {"use_kernels": True} if method == "tam" else {}
    f_gpu, s_gpu = mk(RankMesh(4, 1, 4), layout, cfg, device=cuda,
                      **kw)(O, L, C, D)
    f_cpu, s_cpu = mk(RankMesh(4, 1, 4), layout, cfg, device="cpu",
                      **kw)(O, L, C, D)
    assert torch.equal(f_gpu.cpu(), f_cpu)
    assert (f_cpu.numpy().reshape(-1).tobytes()
            == write_reference(layout, O, L, C, D).tobytes())
    for k in s_cpu:
        assert torch.equal(s_gpu[k].cpu(), s_cpu[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["rle", "ef-int8"])
@pytest.mark.parametrize("method", ["twophase", "tam"])
def test_cuda_codec_write_and_read_equal_cpu(cuda, method, codec):
    """A small BTIO write and read-back with a slow-hop codec: the card
    equals the CPU (file, stats and payloads; within the 5e-2 band of
    the reference's tests for the lossy float codec), and the fused rle
    path launches both zero-skip kernels."""
    from repro_torch.core import (IOConfig, RankMesh, contiguous_layout,
                                  make_tam_read, make_tam_write,
                                  make_twophase_read, make_twophase_write,
                                  write_reference)
    from repro_torch.io_patterns.generators import btio_write_pattern
    O, L, C, D = btio_write_pattern(16, 64, 4, 8, seed=4)
    D = D.copy()
    D[:, ::2] = 0
    if codec == "ef-int8":
        D = D.astype(np.float32) / np.float32(1 << 20)
    layout = contiguous_layout(4 * 64 * 64 * 8, 4)
    ref = write_reference(layout, O, L, C, D)
    cfg = IOConfig(req_cap=O.shape[1], data_cap=D.shape[1],
                   coalesce_cap=64, cb_buffer_size=4096, pipeline=True,
                   pipeline_depth=2, kernel_fusion="fused_round",
                   slow_hop_codec=codec)
    write = make_twophase_write if method == "twophase" else make_tam_write
    read = make_twophase_read if method == "twophase" else make_tam_read
    mesh = RankMesh(4, 1, 4)
    before = (t_fr.zero_skip_encode.launches,
              t_fr.zero_skip_decode.launches)
    f_gpu, s_gpu = write(mesh, layout, cfg, device=cuda)(O, L, C, D)
    p_gpu = read(mesh, layout, cfg, device=cuda)(O, L, C,
                                                 torch.as_tensor(ref))
    f_cpu, s_cpu = write(mesh, layout, cfg, device="cpu")(O, L, C, D)
    p_cpu = read(mesh, layout, cfg, device="cpu")(O, L, C,
                                                  torch.as_tensor(ref))
    for k in s_cpu:
        assert torch.equal(s_gpu[k].cpu(), s_cpu[k]), k
    if codec == "rle":
        assert torch.equal(f_gpu.cpu(), f_cpu)
        assert torch.equal(p_gpu.cpu(), p_cpu)
        assert f_cpu.numpy().reshape(-1).tobytes() == ref.tobytes()
        assert t_fr.zero_skip_encode.launches > before[0]
        assert t_fr.zero_skip_decode.launches > before[1]
    else:
        band = 5e-2 * np.abs(ref).max()
        assert np.abs(f_gpu.cpu().numpy().reshape(-1) - ref).max() < band
        assert (p_gpu.cpu() - p_cpu).abs().max().item() < band


def _sorted_requests(rng, n, cap):
    """Offset-sorted disjoint requests with gaps, PAD tail, packed
    payload starts."""
    gaps = rng.integers(1, 9, size=n)
    lens = rng.integers(1, 6, size=n).astype(np.int32)
    offs = (np.cumsum(gaps) + np.concatenate([[0], np.cumsum(lens)[:-1]])
            ).astype(np.int32)
    o = np.full(cap, PAD, np.int32)
    ln = np.zeros(cap, np.int32)
    st = np.zeros(cap, np.int32)
    o[:n], ln[:n] = offs, lens
    st[:n] = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return o, ln, st, int(lens.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32,
                                   torch.bfloat16, torch.uint8, torch.int64])
@pytest.mark.parametrize("n,cap,base", [(1, 2, 0), (300, 512, 40),
                                        (20000, 32768, 4096 * 5 + 3)])
def test_cuda_pack_equals_plain(cuda, dtype, n, cap, base):
    """The pack kernel equals its plain version exactly, through
    ops.pack (which pads the window to whole tiles)."""
    from repro_torch.kernels import ops as t_ops
    from repro_torch.kernels import pack as t_pack
    rng = np.random.default_rng(n)
    o, ln, st, total = _sorted_requests(rng, n, cap)
    data = _t(rng.integers(1, 100, size=total + 3)).to(cuda).to(dtype)
    r = t_rq.RequestList(_t(o).to(cuda), _t(ln).to(cuda),
                         torch.tensor(n, device=cuda))
    out_len = int(o[n - 1]) + int(ln[n - 1]) + 5 - base
    before = t_pack.pack.launches
    got = t_ops.pack(r, _t(st).to(cuda), data, base, out_len)
    assert t_pack.pack.launches == before + 1
    padded = -(-out_len // t_pack.TILE) * t_pack.TILE
    want = t_ref.pack_ref(r.offsets, r.lengths, _t(st).to(cuda), data, base,
                          padded)[:out_len]
    assert got.dtype == dtype and torch.equal(got, want)


def _attention_close(got, want):
    """Every element within atol = rtol = 5e-3 (f32, the reference's
    kernel test tolerance) or 8e-3 (bf16: one bf16 ulp, 2^-7 relative),
    and a relative L2 distance of at most 1e-2: attention outputs
    average many values, so an absolute limit near their size would let
    a wrong kernel pass."""
    tol = 5e-3 if want.dtype == torch.float32 else 8e-3
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)
    g, w = got.float(), want.float()
    assert float((g - w).norm() / w.norm()) <= 1e-2


# (b, sq, skv, hq, hkv, hd, causal, window, cap, q_offset, kv_len)
FLASH_CASES = [
    (1, 256, 512, 4, 4, 64, True, None, None, 256, None),     # MHA
    (2, 256, 512, 8, 2, 64, True, None, None, 256, None),     # GQA g=4
    (1, 512, 512, 7, 1, 32, True, None, None, 0, None),       # g=7
    (1, 256, 1024, 8, 8, 128, True, None, None, 768, None),   # hd=128
    (2, 256, 512, 4, 2, 64, True, 64, 30.0, 256, None),       # window+cap
    (1, 256, 256, 4, 4, 64, False, None, None, 0, None),      # non-causal
    (1, 512, 512, 16, 8, 256, True, 100, 50.0, 0, None),      # gemma2 local
    (4, 64, 576, 16, 8, 256, False, 300, 50.0, 400, 401),     # decode
    (3, 64, 128, 14, 2, 80, True, None, None, 64, 100),       # hd 80, kv_len
    (1, 256, 512, 8, 8, 128, True, None, None, 256, None),    # g=1 (qwen1.5)
    (1, 256, 512, 32, 2, 128, True, None, None, 256, None),   # g=16 (glm4)
    (1, 1, 8208, 16, 8, 256, False, None, 50.0, 8000, 8001),  # kv_len mid-chunk
    (1, 8, 2048, 4, 2, 64, True, 300, None, 2000, 2008),      # window edges
    (1, 1, 8208, 16, 8, 256, False, None, 50.0, 999, 1000),   # empty chunks
    (1, 16, 4096, 4, 4, 64, True, None, 30.0, 100, None),     # causal, empty
    (1, 1, 32768, 16, 8, 256, False, None, 50.0, 32767, None),  # long cache
    (2, 8, 1000, 16, 8, 128, True, None, 30.0, 992, None),    # 16 rows: split
    (2, 9, 1000, 16, 8, 128, True, None, 30.0, 991, None),    # 18 rows: tc
    (1, 200, 300, 4, 2, 100, True, 90, 30.0, 100, None),      # hd 100: tc
    (2, 1, 700, 8, 4, 100, False, None, 30.0, 650, 651),      # hd 100: split
    (1, 130, 130, 6, 3, 37, True, None, None, 0, None),       # hd 37: tc
    (3, 2, 500, 8, 2, 37, True, 200, 50.0, 400, 450),         # hd 37: split
    (1, 256, 512, 64, 8, 112, True, None, None, 256, None),   # kimi-k2: tc
    (2, 1, 700, 64, 8, 112, False, None, None, 650, 651),     # kimi-k2: split
    (4, 1500, 1500, 6, 6, 64, False, None, None, 0, None),    # whisper encoder
    (4, 32, 1500, 6, 6, 64, False, None, None, 0, None),      # cross-attention
    (4, 1, 1500, 6, 6, 64, False, None, None, 0, None),       # cross, decode
    (1, 608, 608, 56, 8, 128, True, None, None, 0, None),     # llava g=7: tc
    (2, 1, 700, 56, 8, 128, False, None, None, 650, 651),     # llava g=7: split
]


def _expected_route(case, dtype):
    """f32 takes the tensor-core f32 kernel; bf16 the split over the
    cache when a (batch, kv head) has at most 16 (query, head) rows, else
    the tensor-core prefill."""
    _, sq, _, hq, hkv = case[:5]
    if dtype == torch.float32:
        return "tc_f32"
    return "split_decode" if sq * (hq // hkv) <= 16 else "tc_prefill"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_attention_equals_plain(cuda, dtype, case):
    """The flash kernel against flash_attention_ref on the same card
    inputs (both round probabilities and values to bf16 for the PV
    product, and sum in other orders): ``_attention_close``; the call
    launches the route its shape and type name, once."""
    from repro_torch.kernels import flash as t_flash
    b, sq, skv, hq, hkv, hd, causal, window, cap, q_offset, kv_len = case
    gen = torch.Generator(device=cuda)
    gen.manual_seed(sq + skv + hd)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(dtype)
               for s in ((b, sq, hq, hd), (b, skv, hkv, hd),
                         (b, skv, hkv, hd)))
    kw = dict(causal=causal, window=window, logit_cap=cap,
              q_offset=q_offset, kv_len=kv_len)
    before = t_flash.flash_attention_fused.launches
    by_route = dict(t_flash.flash_attention_fused.launches_by_route)
    got = t_flash.flash_attention_fused(q, k, v, block_q=1, block_kv=1,
                                        **kw)
    assert t_flash.flash_attention_fused.launches == before + 1
    by_route[_expected_route(case, dtype)] += 1
    assert t_flash.flash_attention_fused.launches_by_route == by_route
    want = t_ref.flash_attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    _attention_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [FLASH_CASES[6], FLASH_CASES[11],
                                  FLASH_CASES[20], FLASH_CASES[21]])
def test_cuda_flash_takes_unaligned_tensors(cuda, dtype, case):
    """q, k and v that start one element past a 16-byte boundary (views
    into larger buffers) give the plain version's result on the route
    their shape names: every route's tiles load such rows element by
    element."""
    from repro_torch.kernels import flash as t_flash
    b, sq, skv, hq, hkv, hd, causal, window, cap, q_offset, kv_len = case
    gen = torch.Generator(device=cuda)
    gen.manual_seed(sq + skv + hd + 1)

    def off_by_one(shape):
        n = int(np.prod(shape))
        buf = torch.randn(n + 1, generator=gen, device=cuda).to(dtype)
        return buf[1:].view(shape)

    q, k, v = (off_by_one(s) for s in ((b, sq, hq, hd), (b, skv, hkv, hd),
                                       (b, skv, hkv, hd)))
    assert all(t.data_ptr() % 16 for t in (q, k, v))
    kw = dict(causal=causal, window=window, logit_cap=cap,
              q_offset=q_offset, kv_len=kv_len)
    by_route = dict(t_flash.flash_attention_fused.launches_by_route)
    got = t_flash.flash_attention_ragged(q, k, v, **kw)
    by_route[_expected_route(case, dtype)] += 1
    assert t_flash.flash_attention_fused.launches_by_route == by_route
    _attention_close(got, t_ref.flash_attention_ref(q, k, v, **kw))


def _f32_case(cuda, case, seed):
    b, sq, skv, hq, hkv, hd, causal, window, cap, q_offset, kv_len = case
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    q, k, v = (torch.randn(s, generator=gen, device=cuda)
               for s in ((b, sq, hq, hd), (b, skv, hkv, hd),
                         (b, skv, hkv, hd)))
    return q, k, v, dict(causal=causal, window=window, logit_cap=cap,
                         q_offset=q_offset, kv_len=kv_len)


# tc_f32 cases: gemma2 global at the training shape cut to 1024 tokens,
# gemma2 local, a decode-like block, and ragged ones (hd 37, 80, 100)
F32_CASES = [
    (1, 1024, 1024, 16, 8, 256, True, None, 50.0, 0, None),
    FLASH_CASES[6], FLASH_CASES[7], FLASH_CASES[8], FLASH_CASES[18],
    FLASH_CASES[20],
]


# per element, absolute and relative: the worst of F32_CASES reads 1.7e-3
# (H100, seed 11), the plain check's limit is 5e-3
F32_MODEL_TOL = 3e-3


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_CASES)
def test_cuda_flash_f32_equals_its_model(cuda, case):
    """The ``tc_f32`` kernel against ``ref.flash_attention_tc_f32_ref``,
    the model of its arithmetic (split TF32 logits, 32-key tiles, bf16
    p.v), on the same card inputs: every element within
    ``F32_MODEL_TOL`` (one bf16 rounding of a large probability that the
    two summation orders put on either side moves an element by up to
    about 2^-9 |v|) and a relative L2 of at most 5e-4, 20x inside the
    plain check's 1e-2 and above what the orders leave (at most 6.5e-5
    here), so a fault of the kernel's tiles, masks or walk shows here
    apart from precision. Prints its reading (under ``pytest -s``)."""
    from repro_torch.kernels import flash as t_flash
    q, k, v, kw = _f32_case(cuda, case, 11)
    got = t_flash.flash_attention_ragged(q, k, v, **kw)
    want = t_ref.flash_attention_tc_f32_ref(q, k, v, **kw)
    diff = (got - want).abs()
    rel_l2 = float((got - want).norm() / want.norm())
    # the reading, printed under pytest -s
    print(f"tc_f32 vs model {case}: max_abs {float(diff.max())!r} "
          f"least_tol {float((diff / (1 + want.abs())).max())!r} "
          f"rel_l2 {rel_l2!r}")
    torch.testing.assert_close(got, want, rtol=F32_MODEL_TOL,
                               atol=F32_MODEL_TOL)
    assert rel_l2 <= 5e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", [F32_CASES[0], FLASH_CASES[20]])
def test_cuda_flash_f32_repeats_bit_equal(cuda, case):
    """Two calls of the f32 kernel on the same inputs give the same bits
    (every sum in a fixed order), at a gemma2 shape and a ragged one
    (hd 37, rows that do not start on 16 bytes)."""
    from repro_torch.kernels import flash as t_flash
    q, k, v, kw = _f32_case(cuda, case, 12)
    a = t_flash.flash_attention_ragged(q, k, v, **kw)
    b = t_flash.flash_attention_ragged(q, k, v, **kw)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_attention_pads_decode_and_odd_shapes(cuda, dtype):
    """ops.fused_attention on the card: a decode step (Sq 1, kv_len =
    pos + 1 into a longer cache, the window) and odd Sq/Skv, which the
    kernel takes as they are, against the plain version."""
    from repro_torch.kernels import ops as t_ops
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    for (b, sq, skv, causal, window, q_offset, kv_len) in (
            (4, 1, 300, False, 128, 200, 201),
            (1, 200, 300, True, None, 100, None),
            (2, 77, 77, True, 50, 0, None)):
        q, k, v = (torch.randn(s, generator=gen, device=cuda).to(dtype)
                   for s in ((b, sq, 16, 256), (b, skv, 8, 256),
                             (b, skv, 8, 256)))
        kw = dict(causal=causal, window=window, logit_cap=50.0,
                  q_offset=q_offset, kv_len=kv_len)
        got = t_ops.fused_attention(q, k, v, **kw)
        want = t_ref.flash_attention_ref(q, k, v, **kw)
        assert got.shape == q.shape
        _attention_close(got, want)


@pytest.mark.cuda
def test_cuda_decode_attention_reads_the_cache_in_place(cuda):
    """A decode step's attention allocates its output and nothing the
    size of the cache: no padded copy of k and v."""
    from repro_torch.kernels import ops as t_ops
    q = torch.randn((1, 1, 16, 256), device=cuda).bfloat16()
    k, v = (torch.randn((1, 8208, 8, 256), device=cuda).bfloat16()
            for _ in range(2))
    t_ops.fused_attention(q, k, v, causal=False, window=4096,
                          logit_cap=50.0, q_offset=8000, kv_len=8001)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    before = torch.cuda.memory_allocated(cuda)
    t_ops.fused_attention(q, k, v, causal=False, window=4096,
                          logit_cap=50.0, q_offset=8000, kv_len=8001)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(cuda) - before < k.nbytes // 8


@pytest.mark.cuda
def test_cuda_flash_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import flash as t_flash
    q = torch.zeros((1, 64, 2, 16), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        t_flash.flash_attention_fused(q, q, q, block_q=64, block_kv=64)
    q = torch.zeros((1, 64, 2, 512), device=cuda)
    with pytest.raises(ValueError):
        t_flash.flash_attention_fused(q, q, q, block_q=64, block_kv=64)


@pytest.mark.cuda
def test_cuda_serve_matches_cpu_serve(cuda):
    """Reduced gemma2 (window cut to 6) in f32: the card's prefill and
    teacher-forced decode, through the flash kernel, give the CPU's
    plain path's logits within 2e-3; generate runs on the card."""
    from repro_torch import configs
    from repro_torch.kernels import flash as t_flash
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.config import reduced
    cfg = reduced(configs.get("gemma2_9b"), window=6)
    params = T.init_params(0, cfg, dtype=torch.float32, device="cpu")
    params_gpu = _to(params, cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 16)).astype(np.int32))
    before = t_flash.flash_attention_fused.launches
    out = serve.generate(params_gpu, cfg, tokens[:, :8].to(cuda), 4)
    assert out.shape == (2, 5)
    assert t_flash.flash_attention_fused.launches > before
    lg, sg = T.prefill(params_gpu, cfg, {"tokens": tokens[:, :8].to(cuda)})
    lc, sc = T.prefill(params, cfg, {"tokens": tokens[:, :8]})
    torch.testing.assert_close(lg.cpu(), lc, rtol=2e-3, atol=2e-3)
    sg, sc = serve._grow_caches(sg, 8), serve._grow_caches(sc, 8)
    for t in range(8, 16):
        lg, sg = T.decode_step(params_gpu, cfg, sg, tokens[:, t].to(cuda))
        lc, sc = T.decode_step(params, cfg, sc, tokens[:, t])
        torch.testing.assert_close(lg.cpu(), lc, rtol=2e-3, atol=2e-3)


FAMILIES = ["kimi_k2", "mamba2_27b", "jamba_15_large", "llava_next_34b",
            "whisper_tiny"]


def _family_inputs(cfg, b, rng):
    """The non-token inputs of a batch: a vlm's image prefix rows (at
    the token embeddings' scale), an enc-dec's frames (unit normal)."""
    if cfg.frontend == "vision":
        return {"prefix_embeds": torch.from_numpy(rng.normal(
            0, 0.02 * np.sqrt(cfg.d_model),
            (b, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32))}
    if cfg.enc_dec:
        return {"frames": torch.from_numpy(rng.normal(
            0, 1, (b, cfg.enc_seq, cfg.d_model)).astype(np.float32))}
    return {}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILIES)
def test_cuda_family_serve_matches_cpu_serve(cuda, arch):
    """Reduced kimi-k2 (moe), mamba2-2.7b (ssm), jamba-1.5 (hybrid),
    llava-next-34b (vlm: image prefix rows before the tokens) and
    whisper-tiny (enc-dec: encoder, cross-attention) in f32: the card's
    forward (logits and aux loss), prefill and eight teacher-forced
    decode steps give the CPU's logits within 2e-3 (the CPU tests' model
    tolerance); generate runs on the card, its attention (all but
    mamba2) through the flash kernel."""
    from repro_torch import configs
    from repro_torch.kernels import flash as t_flash
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.config import reduced
    cfg = reduced(configs.get(arch))
    params = T.init_params(0, cfg, dtype=torch.float32, device="cpu")
    params_gpu = _to(params, cuda)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(2, 16)).astype(np.int32))
    extra = _family_inputs(cfg, 2, rng)
    extra_gpu = _to(extra, cuda)
    lg, ag = T.forward(params_gpu, cfg, {"tokens": tokens.to(cuda),
                                         **extra_gpu})
    lc, ac = T.forward(params, cfg, {"tokens": tokens, **extra})
    torch.testing.assert_close(lg.cpu(), lc, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(ag.cpu(), ac, rtol=2e-3, atol=2e-3)
    before = t_flash.flash_attention_fused.launches
    out = serve.generate(params_gpu, cfg, tokens[:, :8].to(cuda), 4)
    assert out.shape == (2, 5)
    assert (t_flash.flash_attention_fused.launches > before) == \
        (cfg.family != "ssm")
    lg, sg = T.prefill(params_gpu, cfg, {"tokens": tokens[:, :8].to(cuda),
                                         **extra_gpu})
    lc, sc = T.prefill(params, cfg, {"tokens": tokens[:, :8], **extra})
    torch.testing.assert_close(lg.cpu(), lc, rtol=2e-3, atol=2e-3)
    sg, sc = serve._grow_caches(sg, 8), serve._grow_caches(sc, 8)
    for t in range(8, 16):
        lg, sg = T.decode_step(params_gpu, cfg, sg, tokens[:, t].to(cuda))
        lc, sc = T.decode_step(params, cfg, sc, tokens[:, t])
        torch.testing.assert_close(lg.cpu(), lc, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_cuda_hybrid_decode_state_of_a_period_of_8(cuda):
    """Reduced jamba-1.5's decode state on the card: slot 0 of its period
    of 8 holds a KV cache, slots 1 to 7 SSM and conv states of the same
    shapes at any cache length; after a prefill and four decode steps
    each slot's tensors equal the CPU's within 2e-3."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.config import reduced
    cfg = reduced(configs.get("jamba_15_large"))
    assert cfg.block_period == 8
    st = T.init_decode_state(cfg, 2, 24, device=cuda)
    assert [c is not None for c in st.kv] == [True] + [False] * 7
    assert [c is not None for c in st.ssm] == [False] + [True] * 7
    assert all(x.device.type == "cuda" for c in st.kv + st.ssm
               if c is not None for x in c)
    longer = T.init_decode_state(cfg, 2, 4096, device=cuda)
    assert [tuple(x.shape) for c in st.ssm if c is not None for x in c] == \
        [tuple(x.shape) for c in longer.ssm if c is not None for x in c]
    params = T.init_params(0, cfg, dtype=torch.float32, device="cpu")
    params_gpu = _to(params, cuda)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, 12)).astype(np.int32))
    _, sg = T.prefill(params_gpu, cfg, {"tokens": tokens[:, :8].to(cuda)})
    _, sc = T.prefill(params, cfg, {"tokens": tokens[:, :8]})
    sg, sc = serve._grow_caches(sg, 4), serve._grow_caches(sc, 4)
    for t in range(8, 12):
        _, sg = T.decode_step(params_gpu, cfg, sg, tokens[:, t].to(cuda))
        _, sc = T.decode_step(params, cfg, sc, tokens[:, t])
    assert sg.pos == sc.pos == 12
    for field in ("kv", "ssm"):
        for cg, cc in zip(getattr(sg, field), getattr(sc, field)):
            assert (cg is None) == (cc is None)
            for a, b in zip(cg or (), cc or ()):
                torch.testing.assert_close(a.cpu(), b, rtol=2e-3, atol=2e-3)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _host_reqs(n_ranks, seed):
    from repro_torch.io_patterns.generators import (e3sm_g_pattern,
                                                    sparse_checkpoint_pattern)
    if seed % 2:
        return sparse_checkpoint_pattern(n_ranks, pages_per_rank=8,
                                         page_bytes=512, seed=seed)
    return e3sm_g_pattern(n_ranks, reqs_per_rank=16, req_bytes=96,
                          seed=seed)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [4096, 1 << 30])
@pytest.mark.parametrize("case", ["sorted", "nested"])
def test_cuda_domain_image_packs_uint8_windows_equal_to_plain(cuda, case,
                                                             window):
    """``host_exec.domain_image`` on the card launches ``pack`` on uint8
    window images, one per window, equal to ``pack_ref`` on the CPU."""
    from repro_torch.checkpoint import host_exec
    from repro_torch.kernels import pack as t_pack
    rng = np.random.default_rng(3)
    lens = rng.integers(1, 300, 2000).astype(np.int64)
    offs = np.cumsum(lens + rng.integers(0, 40, 2000)) - lens
    if case == "nested":
        offs[1::7] = offs[0::7][:offs[1::7].size] + 1
        lens[1::7] = 1
        order = np.argsort(offs, kind="stable")
        offs, lens = offs[order], lens[order]
    packed = rng.integers(1, 256, int(lens.sum())).astype(np.uint8)
    args = [torch.from_numpy(x) for x in (offs, lens, packed)]
    want = host_exec.domain_image(*args, 0, 1 << 22, 1, window=window)
    before = t_pack.pack.launches
    got = host_exec.domain_image(*(a.to(cuda) for a in args), 0, 1 << 22,
                                 1, window=window)
    n_win = -(-want.numel() // min(window, host_exec.MAX_PACK_WINDOW))
    assert 0 < t_pack.pack.launches - before <= n_win
    assert got.dtype == torch.uint8 and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["tam", "twophase"])
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_host_write_and_read_equal_the_cpu(cuda, tmp_path, method, seed):
    """The host executor on the card writes the CPU's segments with the
    same modeled timings, and its read returns the CPU's bytes."""
    from repro_torch.checkpoint import HostCollectiveIO
    from repro_torch.core.plan import IOConfig
    from repro_torch.kernels import pack as t_pack
    reqs = _host_reqs(16, seed)
    cfg = IOConfig(req_cap=0, data_cap=0, cb_buffer_size=1024,
                   pipeline=True, slow_hop_codec="rle" if seed else None)
    out = {}
    for dev in ("cpu", cuda):
        io = HostCollectiveIO(n_ranks=16, n_nodes=4, stripe_size=1024,
                              stripe_count=4, device=dev)
        path = str(tmp_path / str(dev).replace(":", ""))
        before = t_pack.pack.launches
        t = io.write(reqs, path, method=method, config=cfg)
        launched = t_pack.pack.launches - before
        got, tr = io.read([(o, ln) for o, ln, _ in reqs], path, config=cfg)
        assert all(x.device.type == torch.device(dev).type for x in got)
        out[str(dev)] = (
            [open(f"{path}.seg{g}", "rb").read() for g in range(4)],
            {k: v for k, v in vars(t).items() if k != "plan_seconds"},
            [x.cpu().numpy().tobytes() for x in got],
            {k: v for k, v in vars(tr).items() if k != "plan_seconds"},
            launched)
    cpu, card = out["cpu"], out[str(cuda)]
    assert cpu[0] == card[0] and cpu[1] == card[1]
    assert cpu[2] == card[2] and cpu[3] == card[3]
    assert cpu[4] == 0 and card[4] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["tam", "twophase"])
def test_cuda_mp_write_after_cuda_is_initialised(cuda, tmp_path, method):
    """The mp executor forks its workers after the card is in use; the
    workers touch host copies only, and the segments equal the host
    executor's on the card."""
    from repro_torch.checkpoint import HostCollectiveIO
    from repro_torch.core.plan import IOConfig
    torch.ones(1, device=cuda).sum().item()        # CUDA initialised
    reqs = _host_reqs(16, 0)
    io = HostCollectiveIO(n_ranks=16, n_nodes=4, stripe_size=1024,
                          stripe_count=2, device=cuda)
    segs = []
    for name, transport in (("h", None), ("m", "mp")):
        cfg = IOConfig(req_cap=0, data_cap=0, cb_buffer_size=256,
                       pipeline=True, slow_hop_codec="rle",
                       transport=transport)
        t = io.write(reqs, str(tmp_path / name), method=method, config=cfg)
        assert t.transport == transport
        segs.append([open(str(tmp_path / f"{name}.seg{g}"), "rb").read()
                     for g in range(2)])
    assert segs[0] == segs[1]
    got, _ = io.read([(o, ln) for o, ln, _ in reqs], str(tmp_path / "m"),
                     config=IOConfig(req_cap=0, data_cap=0,
                                     cb_buffer_size=256, transport="mp"))
    for x, (_, _, d) in zip(got, reqs):
        assert x.device.type == "cuda"
        np.testing.assert_array_equal(x.cpu().numpy(), d)


@pytest.mark.cuda
@pytest.mark.parametrize("case,rows,n", [
    ("long_runs", 16, 131072), ("all_pad", 16, 131072),
    ("tail", 3, 65536), ("wrap", 2, 65536), ("few_runs", 2, 131072),
    ("many_runs", 4, 131072), ("edges", 4, 131072)])
def test_cuda_ops_coalesce_of_rows_longer_than_one_block(cuda, case, rows,
                                                         n, monkeypatch):
    """TAM stage 1 at 1024 requests a rank gives rows of 131072: the
    wrapper's kernel passes on the card equal the plain version on the
    whole row, with more runs than one block holds too, and no plain
    version runs on the card."""
    from repro_torch.kernels import ops as t_ops
    offs, lens = _long_coalesce_case(np.random.default_rng(7), case, rows,
                                     n)
    o, ln = _t(offs).to(cuda), _t(lens).to(cuda)
    want = t_ref.coalesce_ref(o, ln)

    def refuse(*a, **k):
        raise AssertionError("the plain coalesce ran on the card")
    monkeypatch.setattr(t_ref, "coalesce_ref", refuse)
    monkeypatch.setattr(t_ck, "coalesce_ref", refuse)
    before = t_ck.coalesce.launches
    got = t_ops.coalesce(t_rq.RequestList(o, ln, torch.zeros(
        rows, dtype=torch.int32, device=cuda)))
    assert t_ck.coalesce.launches > before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------- backward

def _grad_check(got, want):
    """The backward kernel against ``flash_attention_bwd_ref`` given the
    same forward output (``chip_smoke.BWD_TOL``): every element within
    rtol 1.6e-2 (dv and each dP are rounded to bf16, and a sum in another
    order may round to a neighbour, two ulps across a power of two) plus
    atol 2e-3 x max|want| (f32: a dP rounded the other way under a
    probability near 1) or 1e-2 x max|want| (bf16 outputs); and a
    relative L2 distance of at most 1e-4 (f32) or 1e-2 (bf16), which is
    what a wrong gradient fails. Returns ``(ok, rel_l2)``."""
    g, w = got.float(), want.float()
    f32 = want.dtype == torch.float32
    rtol, atol, l2 = (1.6e-2, 2e-3, 1e-4) if f32 else (1.6e-2, 1e-2, 1e-2)
    scale = float(w.abs().max())
    elem = bool(((g - w).abs() <= rtol * w.abs() + atol * scale).all())
    rel = float((g - w).norm() / w.norm().clamp(min=1e-30))
    return elem and rel <= l2, rel


# (b, sq, skv, hq, hkv, hd, causal, window, cap, q_offset, kv_len).
# Every row sees a key: a row that sees none gets no gradient from the
# kernel (its forward gives it a zero output), while the plain version
# spreads it over the masked keys of its chunk.
BWD_CASES = [
    (1, 256, 256, 4, 2, 64, True, None, 50.0, 0, None),       # GQA + cap
    (2, 100, 300, 8, 2, 37, True, 40, 30.0, 200, 290),        # ragged
    (1, 64, 64, 4, 4, 16, False, None, None, 0, None),        # MHA
    (1, 130, 130, 6, 3, 256, True, 17, 50.0, 0, None),        # window
    (3, 5, 700, 16, 8, 100, False, None, 50.0, 650, 651),     # decode-like
    (1, 96, 5000, 4, 2, 32, True, None, None, 4904, None),    # > 1 chunk
    (1, 33, 33, 7, 1, 128, True, None, None, 0, None),        # g = 7
    # the tiles' edges: 64 keys a dk/dv CTA, 64 rows a dq CTA, 32 rows a
    # dk/dv block; one short of each, one past, and neither
    (1, 63, 63, 2, 2, 64, True, None, 50.0, 0, None),         # 63 rows, keys
    (1, 31, 191, 4, 4, 128, False, None, 30.0, 0, 150),       # 31 rows
    (2, 65, 129, 4, 2, 64, True, 50, None, 64, None),         # 130 rows
    (1, 70, 70, 4, 2, 8, True, None, 50.0, 0, None),          # hd 8
    (1, 50, 90, 2, 1, 255, True, 33, 50.0, 40, None),         # hd 255
    # causal with rows longest last: the grids' reversed order
    (1, 1000, 1000, 4, 2, 128, True, None, 50.0, 0, None),
]
# rows of more than one 4096-key chunk: the plain version takes the row
# max and rounds p to bf16 a chunk at a time, the kernel once a row
# (f32; bf16 keeps its 1e-2)
BWD_MULTI_CHUNK_REL_L2 = 2e-3


def _bwd_inputs(cuda, case, dtype, seed=1):
    b, sq, skv, hq, hkv, hd, causal, window, cap, q_offset, kv_len = case
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    # logits of a few units (q, k of std 2), so the softcap bends them
    q, k = ((2 * torch.randn(s, generator=gen, device=cuda)).to(dtype)
            for s in ((b, sq, hq, hd), (b, skv, hkv, hd)))
    v = torch.randn((b, skv, hkv, hd), generator=gen, device=cuda).to(dtype)
    dout = torch.randn((b, sq, hq, hd), generator=gen, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, logit_cap=cap,
              q_offset=q_offset, kv_len=kv_len)
    return q, k, v, dout, kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES)
def test_cuda_flash_bwd_equals_plain(cuda, dtype, case):
    """dq, dk, dv from ``csrc/flash_bwd.cu`` against the autograd
    gradient of the plain attention (``_grad_check``), one launch."""
    from repro_torch.kernels import flash as t_flash
    q, k, v, dout, kw = _bwd_inputs(cuda, case, dtype)
    out = t_ref.flash_attention_ref(q, k, v, **kw)
    before = t_flash.flash_attention_bwd.launches
    got = t_flash.flash_attention_bwd(q, k, v, out, dout, **kw)
    assert t_flash.flash_attention_bwd.launches == before + 1
    want = t_ref.flash_attention_bwd_ref(q, k, v, out, dout, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        ok, rel = _grad_check(g, w)
        if case[2] > t_ref.ATTENTION_CHUNK:   # the L2 limit only
            ok = rel <= (BWD_MULTI_CHUNK_REL_L2 if dtype == torch.float32
                         else 1e-2)
        assert ok, (name, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_bwd_repeats_bit_equal(cuda, dtype):
    """No atomics: the same inputs give the same bits."""
    from repro_torch.kernels import flash as t_flash
    q, k, v, dout, kw = _bwd_inputs(cuda, BWD_CASES[1], dtype)
    out = t_ref.flash_attention_ref(q, k, v, **kw)
    a = t_flash.flash_attention_bwd(q, k, v, out, dout, **kw)
    b = t_flash.flash_attention_bwd(q, k, v, out, dout, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [BWD_CASES[7], BWD_CASES[12]])
def test_cuda_flash_bwd_repeats_bit_equal_at_the_tiles_edges(cuda, dtype,
                                                            case):
    """Bit-equal repeats where the tiles end mid-block and where the
    causal grids run in reverse."""
    from repro_torch.kernels import flash as t_flash
    q, k, v, dout, kw = _bwd_inputs(cuda, case, dtype, seed=2)
    out = t_ref.flash_attention_ref(q, k, v, **kw)
    a = t_flash.flash_attention_bwd(q, k, v, out, dout, **kw)
    b = t_flash.flash_attention_bwd(q, k, v, out, dout, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_bwd_passes_one_at_a_time_equal_the_full_call(cuda, dtype):
    """The pass mask that times the passes apart: stats, dq and dk/dv
    launched one at a time give the full call's bits, and a mask outside
    1..7 is refused."""
    from repro_torch.kernels import flash as t_flash
    q, k, v, dout, kw = _bwd_inputs(cuda, BWD_CASES[1], dtype)
    out = t_ref.flash_attention_ref(q, k, v, **kw)
    want = t_flash.flash_attention_bwd(q, k, v, out, dout, **kw)
    kw = {**kw, "kv_len": min(kw["kv_len"], k.shape[1])}
    grads = [torch.full_like(t, float("nan")) for t in (q, k, v)]
    scratch = t_flash.bwd_scratch(q, k.shape[1])
    for passes in (1, 2, 4):
        t_flash._launch_bwd(q, k, v, out, dout, grads, scratch, kw, passes)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    with pytest.raises(RuntimeError, match="flash_attention_bwd failed"):
        t_flash._launch_bwd(q, k, v, out, dout, grads, scratch, kw, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [BWD_CASES[1], BWD_CASES[7],
                                  BWD_CASES[11]])
def test_cuda_flash_bwd_recomputed_logits_equal_the_kept_ones(cuda, dtype,
                                                              case):
    """Past ``BWD_DOTS_MAX_BYTES`` each pass recomputes q . k instead of
    reading what the stats pass kept: the same bits."""
    from unittest import mock
    from repro_torch.kernels import flash as t_flash
    q, k, v, dout, kw = _bwd_inputs(cuda, case, dtype)
    out = t_ref.flash_attention_ref(q, k, v, **kw)
    kept = t_flash.flash_attention_bwd(q, k, v, out, dout, **kw)
    assert t_flash.bwd_scratch(q, k.shape[1])[2] is not None
    with mock.patch.object(t_flash, "BWD_DOTS_MAX_BYTES", 0):
        assert t_flash.bwd_scratch(q, k.shape[1])[2] is None
        again = t_flash.flash_attention_bwd(q, k, v, out, dout, **kw)
    for x, y in zip(kept, again):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_flash_bwd_planted_faults_fail_the_check(cuda):
    """Gradients made wrong on purpose fail ``_grad_check``: the kernel
    with the window one key short, the kernel with the D term dropped
    (``out`` zeroed: D = dO' . out), and the plain backward with the
    softcap's derivative dropped (a straight-through tanh)."""
    from unittest import mock
    from repro_torch.kernels import flash as t_flash
    case = BWD_CASES[3]
    q, k, v, dout, kw = _bwd_inputs(cuda, case, torch.float32)
    out = t_ref.flash_attention_ref(q, k, v, **kw)
    want = t_ref.flash_attention_bwd_ref(q, k, v, out, dout, **kw)
    tanh = torch.tanh
    with mock.patch.object(torch, "tanh",
                           lambda x: x + (tanh(x) - x).detach()):
        no_dcap = t_ref.flash_attention_bwd_ref(q, k, v, out, dout, **kw)
    faults = {
        "window_short": t_flash.flash_attention_bwd(
            q, k, v, out, dout, **{**kw, "window": kw["window"] - 1}),
        "d_dropped": t_flash.flash_attention_bwd(
            q, k, v, torch.zeros_like(out), dout, **kw),
        "softcap_derivative_dropped": no_dcap}
    for name, got in faults.items():
        assert not all(_grad_check(g, w)[0] for g, w in zip(got, want)), name


@pytest.mark.cuda
def test_cuda_attention_gradient_goes_through_the_kernel(cuda, monkeypatch):
    """``layers.flash_attention`` on CUDA tensors that require grad
    returns an output with a grad_fn whose backward launches the kernel,
    with every plain attention made to raise."""
    from repro_torch.kernels import flash as t_flash
    from repro_torch.models import layers as t_layers
    q, k, v, dout, kw = _bwd_inputs(cuda, BWD_CASES[0], torch.float32)
    want = t_ref.flash_attention_bwd_ref(
        q, k, v, t_ref.flash_attention_ref(q, k, v, **kw), dout, **kw)

    def refuse(*a, **k):
        raise AssertionError("a plain attention ran on the card")
    for mod in (t_ref, t_flash, t_layers.ref):
        for name in ("flash_attention_ref", "flash_attention_bwd_ref"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, refuse)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fwd = t_flash.flash_attention_fused.launches
    bwd = t_flash.flash_attention_bwd.launches
    out = t_layers.flash_attention(*leaves, **kw)
    assert out.grad_fn is not None
    out.backward(dout)
    assert t_flash.flash_attention_fused.launches == fwd + 1
    assert t_flash.flash_attention_bwd.launches == bwd + 1
    # the kernel forward's output feeds D: the f32 limit of the check
    # with the plain forward's output does not apply, the bf16 one does
    for x, w in zip(leaves, want):
        g, ww = x.grad.float(), w.float()
        assert float((g - ww).norm() / ww.norm()) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("async_checkpoint", [False, True])
def test_cuda_train_loop_saves_and_restores_byte_for_byte(cuda, tmp_path,
                                                          async_checkpoint,
                                                          monkeypatch):
    """Two steps of reduced gemma2 on the card with a checkpoint after
    each (sync or async): the losses are finite, the attention ran its
    kernels both ways, ``pack`` built the images, and the last
    checkpoint restores to the final state byte for byte."""
    from repro_torch import kernels
    from repro_torch._tree import leaves
    from repro_torch.kernels import flash as t_flash
    from repro_torch.launch.train import build_training

    def refuse(*a, **k):
        raise AssertionError("the plain backward ran on the card")
    monkeypatch.setattr(t_flash, "flash_attention_bwd_ref", refuse)
    run = build_training("gemma2_9b", smoke=True, steps=2, batch=2, seq=32,
                         ckpt_dir=str(tmp_path), ckpt_every=1, log_every=1,
                         async_checkpoint=async_checkpoint, device=cuda)
    kernels.reset_launch_counts()
    loop = run.loop()
    params, opt_state, step = loop.run(run.params, run.opt_state)
    counts = kernels.launch_counts()
    assert step == 2 and all(np.isfinite(loop.losses))
    assert counts["flash_attention_fused"] > 0
    assert counts["flash_attention_bwd"] > 0 and counts["pack"] > 0
    got, got_step = run.ckpt.restore({"params": params, "opt": opt_state})
    assert got_step == 2
    for a, b in zip(leaves(got), leaves({"params": params,
                                         "opt": opt_state})):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


# ---------------------------------------------------------------------------
# the mesh paths on the emulated rank grid (plain PyTorch on the card,
# as the reference's jnp / lax): card against CPU
# ---------------------------------------------------------------------------

MESH_ATTN = [(pos, window, cap, dtype) for pos in (5, 16, 60)
             for window, cap in ((None, None), (8, 20.0))
             for dtype in (torch.float32, torch.bfloat16)]


def _mesh_plan(form, data_axes=("data",)):
    from repro_torch.compat import EmulatedMesh
    from repro_torch.models.sharding import ShardingPlan
    return ShardingPlan(mesh=EmulatedMesh((2, 4), ("data", "model")),
                        data_axes=data_axes, model_axis="model",
                        shard_seq=form == "seq")


@pytest.mark.cuda
@pytest.mark.parametrize("pos,window,cap,dtype", MESH_ATTN,
                         ids=[f"pos{p}-w{w}-{str(d)[6:]}"
                              for p, w, _, d in MESH_ATTN])
def test_cuda_decode_attention_sharded_equals_the_cpu(cuda, pos, window, cap,
                                                      dtype):
    from repro_torch.models import layers as TL
    g = torch.Generator().manual_seed(pos)
    q, k, v = (torch.randn(shape, generator=g).to(dtype) for shape in (
        (4, 1, 8, 16), (4, 64, 2, 16), (4, 64, 2, 16)))
    kw = dict(cache_pos=pos, window=window, logit_cap=cap,
              plan=_mesh_plan("decode"))
    want = TL.decode_attention_sharded(q, k, v, **kw)
    got = TL.decode_attention_sharded(q.to(cuda), k.to(cuda), v.to(cuda),
                                      **kw)
    assert got.dtype == dtype and got.device.type == "cuda"
    tol = 2e-3 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("form,experts,top_k,cf", [
    ("seq", 4, 2, 4.0), ("seq", 8, 2, 1.25), ("decode", 4, 2, 1.25),
    ("decode", 32, 8, 4.0)])
def test_cuda_moe_sharded_equals_the_cpu(cuda, form, experts, top_k, cf):
    """Both forms in f32, drops included: the same slot for every
    (token, k) entry of every rank, and the output, aux and gradients
    within 2e-3 of the CPU's."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import layers as TL
    from repro_torch.models import moe_sharded as TMS
    from repro_torch.models.config import reduced
    cfg = reduced(configs.get("kimi_k2"))
    cfg = dataclasses.replace(cfg, d_model=32, moe=dataclasses.replace(
        cfg.moe, num_experts=experts, top_k=top_k, capacity_factor=cf))
    g = torch.Generator().manual_seed(experts)
    p = TL.init_moe(g, cfg, dtype=torch.float32)
    shape = (4, 32, 32) if form == "seq" else (16, 1, 32)
    x = torch.randn(shape, generator=g) + 1.0
    plan = _mesh_plan(form)
    r_c = TMS.sharded_route(p, x, cfg, plan)
    r_g = TMS.sharded_route({k_: v.to(cuda) for k_, v in p.items()},
                            x.to(cuda), cfg, plan)
    assert torch.equal(r_g.slot.cpu(), r_c.slot)
    assert torch.equal(r_g.eids.cpu(), r_c.eids)
    outs = []
    for dev in ("cpu", cuda):
        pd = {k_: v.detach().to(dev).requires_grad_() for k_, v in p.items()}
        xd = x.detach().to(dev).requires_grad_()
        out, aux = TL.moe(pd, xd, cfg, plan=plan)
        (out.square().sum() + aux).backward()
        outs.append([t.detach().cpu() for t in (
            out, aux, xd.grad, *(pd[k_].grad for k_ in sorted(pd)))])
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(2, 4), (4, 2)])
def test_cuda_two_layer_collectives_equal_the_cpu(cuda, grid):
    from repro_torch import compat as C
    from repro_torch.core import hierarchical as H
    R = C.Ranks.of(C.EmulatedMesh(grid, ("pod", "ici")), ("pod", "ici"))
    g = torch.Generator().manual_seed(grid[0])
    x = torch.randn(*grid, 1000, 3, generator=g)
    want = H.two_layer_psum(x, R, "ici", "pod")
    got = H.two_layer_psum(x.to(cuda), R, "ici", "pod").cpu()
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    a = torch.arange(8 * 8 * 5, dtype=torch.int32).reshape(*grid, 8, 5)
    for t in (a, a.to(torch.bfloat16)):
        want = H.two_layer_all_to_all(t, R, "ici", "pod")
        got = H.two_layer_all_to_all(t.to(cuda), R, "ici", "pod").cpu()
        assert torch.equal(got, want)
        assert torch.equal(got.reshape(8, 8, 5),
                           t.reshape(8, 8, 5).transpose(0, 1))
    res = torch.zeros_like(x)
    out_c, res_c = H.compressed_psum(x, res, R, "ici", "pod")
    out_g, res_g = H.compressed_psum(x.to(cuda), res.to(cuda), R, "ici",
                                     "pod")
    step = float(x.sum(1).abs().max() / 127)
    assert (out_g.cpu() - out_c).abs().max() <= step
    assert (res_g.cpu() - res_c).abs().max() <= step
