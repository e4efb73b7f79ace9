"""The algorithms of the pack tile walk and the chunked zero-skip encode,
on the CPU.

``kernels.ref.pack_tile_walk_ref`` is the plain version of the tile
kernel that ``fused_sort_pack`` and ``pack`` run on the card
(``csrc/pack_tiles.cuh``): per tile of 4096 positions a carry-in search,
heads of the tile's requests (the last of equal offsets winning) and a
max-scan, with a per-position search where p wraps past 2^31 - 1.
``kernels.ref.zero_skip_encode_chunked_ref`` is the plain version of
``zero_skip_encode``'s kernels (``csrc/zero_skip.cu``): chunk counts, an
exclusive scan over the chunks, per-chunk slots and the padding launch.
Each is held exactly against the port's plain versions
(``fused_sort_pack_ref``, ``pack_ref``, ``zero_skip_encode_ref``) and
against the reference's Pallas kernels in interpret mode. Inputs come
from numpy with a seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import fused_round as j_fr  # noqa: E402
from repro.kernels import pack as j_pack  # noqa: E402
from repro.kernels import sort as j_sort  # noqa: E402

from repro_torch.core import requests as t_rq  # noqa: E402
from repro_torch.kernels import fused_round as t_fr  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402

PAD = t_rq.PAD_OFFSET
TILE = t_ref.TILE
BF16 = np.dtype(jnp.bfloat16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    x = np.array(x)                 # a writable copy
    if x.dtype == BF16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


# ------------------------------------------------------------ tile walk

def _lists(rng, rows, cap, out_len, base, case):
    """Unsorted ``[rows, cap]`` request lists for windows at ``base``
    (one per row) with a third PAD_OFFSET padding, and their starts:
    - ``disjoint``: disjoint requests with gaps inside the window or past
      it, none reaching 2^31 - 1, some repeated whole; a request's
      payload sits at its offset less the base, so a duplicate carries
      the same payload (what valid drain input makes);
    - ``nested``: requests inside longer ones, equal offsets of other
      lengths, zero lengths, offsets before the window;
    - ``wrap``: offsets up to 2^31 - 2 and below -2^31 + 8192, where
      p = position + base wraps inside a tile (``base`` near 2^31);
    - ``zero_len``: every request of zero length."""
    n = cap - cap // 3
    offs = np.full((rows, cap), PAD, np.int64)
    lens = np.zeros((rows, cap), np.int64)
    starts = rng.integers(0, 4000, size=(rows, cap))
    for r in range(rows):
        b = int(base[r])
        if case == "disjoint":
            k = n // 2
            gaps = rng.integers(0, 2 * out_len // k, size=k)
            ln = rng.integers(1, out_len // k, size=k)
            o = b + np.cumsum(gaps) + np.concatenate(
                [[0], np.cumsum(ln)[:-1]])
            ok = o + ln < PAD
            o, ln = np.where(ok, o, PAD), np.where(ok, ln, 0)
            dup = rng.integers(0, k, size=n - k)
            o, ln = np.concatenate([o, o[dup]]), np.concatenate([ln, ln[dup]])
        elif case == "nested":
            o = b + rng.integers(-300, out_len + 300, size=n)
            o[: n // 4] = o[n // 4: 2 * (n // 4)]    # equal offsets
            ln = rng.integers(0, 3 * out_len // n + 400, size=n)
        elif case == "wrap":
            high = rng.integers(PAD - 3 * TILE // 2, PAD - 1, size=n // 2)
            low = rng.integers(-(1 << 31), -(1 << 31) + 2 * TILE,
                               size=n - n // 2)
            o = np.concatenate([high, low])
            ln = rng.integers(0, 40, size=n)
        else:
            o = b + rng.integers(0, out_len, size=n)
            ln = np.zeros(n, np.int64)
        slots = rng.permutation(cap)[:n]
        offs[r, slots], lens[r, slots] = o, ln
        if case == "disjoint":
            starts[r] = np.where(lens[r] > 0, offs[r] - b, 0)
    return (offs.astype(np.int32), lens.astype(np.int32),
            starts.astype(np.int32))


def _sorted(offs, lens, starts):
    return t_ref.sort_ref(_t(offs), _t(lens), _t(starts))


CASES = [("disjoint", [0, 5000]), ("nested", [4096, -700]),
         ("wrap", [(1 << 31) - 5000, (1 << 31) - 4096 - 17]),
         ("zero_len", [123, 0])]


@pytest.mark.parametrize("case,base", CASES, ids=[c for c, _ in CASES])
@pytest.mark.parametrize("cap", [64, 1024])
def test_tile_walk_equals_pack_ref(case, base, cap):
    """Every case, row by row, equals the per-position search of
    ``pack_ref`` (window) and of ``pack_ref`` over ones (mask): nested
    requests (only r decides), duplicate offsets, zero lengths, padding
    and tiles whose p wraps."""
    rng = np.random.default_rng(cap + len(case))
    out_len = 3 * TILE
    offs, lens, starts = _lists(rng, 2, cap, out_len, base, case)
    data = _t(rng.integers(1, 1 << 30, size=(2, 4000)).astype(np.int32))
    so, sl, ss = _sorted(offs, lens, starts)
    win, mask = t_ref.pack_tile_walk_ref(so, sl, ss, data,
                                         torch.tensor(base), out_len)
    for r in range(2):
        want = t_ref.pack_ref(so[r], sl[r], ss[r], data[r], base[r], out_len)
        ones = t_ref.pack_ref(so[r], sl[r], ss[r], torch.ones_like(data[r]),
                              base[r], out_len)
        assert torch.equal(win[r], want)
        assert torch.equal(mask[r], ones)
    if case != "zero_len":
        assert int(mask.sum()) > 0
    else:
        assert int(mask.sum()) == 0


WRAP_BASE = [(1 << 31) - 5000, (1 << 31) - 4096 - 17]


@pytest.mark.parametrize("case,base", [("disjoint", [0, 5000]),
                                       ("disjoint", WRAP_BASE),
                                       ("zero_len", [123, 0])],
                         ids=["disjoint", "disjoint_wrap", "zero_len"])
@pytest.mark.parametrize("dtype", [np.int32, np.uint8, np.int64])
def test_tile_walk_equals_fused_sort_pack_ref(case, base, dtype):
    """On what valid input makes (disjoint requests, duplicates with
    the same payload, no request reaching 2^31 - 1), also where a tile's
    p wraps, the walk over the sorted lists equals
    ``fused_sort_pack_ref`` (sort + two scatter-form ``pack_data``), the
    plain version the card is held to."""
    rng = np.random.default_rng(len(case) + np.dtype(dtype).itemsize)
    out_len, cap = 2 * TILE, 512
    offs, lens, starts = _lists(rng, 2, cap, out_len, base, case)
    data = _t((rng.integers(1, 120, size=(2, 3 * out_len))).astype(dtype))
    b = torch.tensor(base, dtype=torch.int32)
    so, sl, ss = _sorted(offs, lens, starts)
    got = t_ref.pack_tile_walk_ref(so, sl, ss, data, b, out_len)
    want = t_ref.fused_sort_pack_ref(_t(offs), _t(lens), _t(starts), data,
                                     b, out_len)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if case != "zero_len":
        assert int(got[1].sum()) > 0


@pytest.mark.parametrize("case,base", [
    CASES[1], CASES[2], ("wrap", [(1 << 31) - 9000, (1 << 31) - 4096])],
    ids=["nested", "wrap", "wrap_overflow"])
def test_tile_walk_equals_pallas_fused_sort_pack(case, base):
    """Nested requests, equal offsets and wrapping tiles: the walk over
    the lists as the reference's own bitonic network orders them (it is
    not stable, and among equal offsets the last decides) equals the
    reference's Pallas ``fused_sort_pack`` (interpret mode), window and
    mask, row by row. ``wrap_overflow``: positions whose request lies
    more than 2^31 below them, where ``p - off[r]`` wraps in int32 (as on
    the TPU) and covers them."""
    rng = np.random.default_rng(7 + len(case))
    out_len, cap = 2 * TILE, 64
    offs, lens, starts = _lists(rng, 2, cap, out_len, base, case)
    data = rng.integers(1, 1 << 30, size=(2, 4000)).astype(np.int32)
    so, sl, ss = (_t(np.asarray(x)) for x in j_sort.bitonic_sort(
        jnp.asarray(offs), jnp.asarray(lens), jnp.asarray(starts),
        interpret=True))
    win, mask = t_ref.pack_tile_walk_ref(so, sl, ss, _t(data),
                                         torch.tensor(base), out_len)
    for r in range(2):
        jw, jm = j_fr.fused_sort_pack(
            jnp.asarray(offs[r]), jnp.asarray(lens[r]),
            jnp.asarray(starts[r]), jnp.asarray(data[r]), base[r], out_len,
            interpret=True)
        np.testing.assert_array_equal(win[r].numpy(), np.asarray(jw))
        np.testing.assert_array_equal(mask[r].numpy(), np.asarray(jm))
    assert int(mask.sum()) > 0


def test_tile_walk_equals_pallas_pack():
    """One sorted, disjoint row (``pack``'s input) at a base whose
    second tile wraps: equal to the reference's Pallas ``pack``."""
    rng = np.random.default_rng(11)
    base, out_len, cap = [(1 << 31) - TILE - 900], 2 * TILE, 128
    offs, lens, starts = _lists(rng, 1, cap, out_len, base, "wrap")
    so, sl, ss = _sorted(offs, lens, starts)
    data = rng.integers(1, 1 << 30, size=4000).astype(np.int32)
    win, _ = t_ref.pack_tile_walk_ref(so, sl, ss, _t(data[None]),
                                      base[0], out_len)
    want = j_pack.pack(jnp.asarray(so[0].numpy()), jnp.asarray(sl[0].numpy()),
                       jnp.asarray(ss[0].numpy()), jnp.asarray(data),
                       base[0], out_len, interpret=True)
    np.testing.assert_array_equal(win[0].numpy(), np.asarray(want))


# ------------------------------------------------- chunked zero-skip encode

DTYPES = [np.uint8, np.int8, np.int16, np.float16, BF16, np.int32,
          np.float32, np.int64, np.float64, np.bool_]


def _rows(rng, rows, n, dtype):
    """About half zeros, an all-zero and a no-zero row; float rows also
    hold -0.0 (a zero) and NaN (a nonzero)."""
    x = (rng.integers(-5, 6, size=(rows, n))
         * (rng.random((rows, n)) < 0.5)).astype(np.float64)
    x[0] = 0
    if rows > 1:
        x[1] = np.where(x[1] == 0, 3, x[1])
    if np.dtype(dtype).kind == "f" or dtype == BF16:
        x = x * 0.75
        if rows > 2:
            x[2, ::3] = -0.0
            x[2, 1::7] = np.nan
    if dtype == np.bool_:
        return x != 0
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("rows,n,chunk", [(3, 1, 4096), (3, 8, 4096),
                                          (4, 64, 16), (5, 256, 1),
                                          (3, 8192, 4096), (2, 4096, 4096)])
def test_chunked_encode_equals_zero_skip_encode_ref(dtype, rows, n, chunk):
    """Chunks of one element to the whole row, rows shorter than one
    chunk, every width and both zero tests: the chunked algorithm equals
    the plain stable partition, and every slot is written."""
    x = _t(_rows(np.random.default_rng(n + rows), rows, n, dtype))
    vals, pos = t_ref.zero_skip_encode_chunked_ref(x, chunk)
    wv, wp = t_ref.zero_skip_encode_ref(x)
    assert vals.dtype == wv.dtype and _bytes(vals) == _bytes(wv)
    assert torch.equal(pos, wp)
    assert torch.equal(t_ref.zero_skip_nonzero(x), x != 0)


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float16, BF16,
                                   np.int32, np.float32],
                         ids=lambda d: np.dtype(d).name)
def test_chunked_encode_equals_pallas_zero_skip_encode(dtype):
    """The chunked algorithm at the kernel's chunk equals the reference's
    Pallas ``zero_skip_encode`` in interpret mode, bit for bit (widths up
    to 4 bytes: JAX runs with 64-bit types off)."""
    x = _rows(np.random.default_rng(3), 4, 8192, dtype)
    vals, pos = t_ref.zero_skip_encode_chunked_ref(_t(x), t_fr.ENCODE_TILE)
    jv, jp = j_fr.zero_skip_encode(jnp.asarray(x), interpret=True)
    assert _bytes(vals) == _bytes(jv)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jp))


@pytest.mark.parametrize("rows,n,sms,want", [
    (16, 262144, 132, 64), (256, 262144, 132, 1), (16384, 131072, 132, 1),
    (132, 8192, 132, 1), (131, 8192, 132, 2), (7, 4096, 132, 1),
    (7, 1, 132, 1)])
def test_encode_chunks_at_the_path_shapes(rows, n, sms, want):
    """A read's 16 windows take one tile a chunk; TAM's 256 and the
    two-phase 16384 rle buckets, at least one row a SM, one CTA a row."""
    assert t_fr.encode_chunks(rows, n, sms) == want


@pytest.mark.parametrize("dtype", [torch.complex64, torch.float8_e4m3fn,
                                   torch.float8_e5m2])
def test_zero_skip_kind_refuses_what_no_bit_test_decides(dtype):
    with pytest.raises(TypeError):
        t_fr.zero_skip_kind("zero_skip_encode", dtype)


@pytest.mark.parametrize("dtype,kind", [
    (torch.uint8, (1, False)), (torch.bool, (1, False)),
    (torch.int16, (2, False)), (torch.bfloat16, (2, True)),
    (torch.float16, (2, True)), (torch.int32, (4, False)),
    (torch.float32, (4, True)), (torch.int64, (8, False)),
    (torch.float64, (8, True))])
def test_zero_skip_kind_of_every_width(dtype, kind):
    assert t_fr.zero_skip_kind("zero_skip_encode", dtype) == kind
