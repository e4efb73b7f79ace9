"""The port's kernel wrappers against the reference's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the reference's
kernels run in interpret mode, as ``tests/test_kernels.py`` runs them.
Inputs come from numpy with a seed and go to both sides; every
comparison is exact. ``test_torch_cuda.py`` holds each CUDA kernel
against its plain version on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import coalesce as j_co  # noqa: E402
from repro.core.requests import RequestList as JRequestList  # noqa: E402
from repro.kernels import coalesce_kernel as j_ck  # noqa: E402
from repro.kernels import fused_round as j_fr  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels import sort as j_sort  # noqa: E402

from repro_torch import kernels as t_kernels  # noqa: E402
from repro_torch.core import requests as t_rq  # noqa: E402
from repro_torch.kernels import coalesce_kernel as t_ck  # noqa: E402
from repro_torch.kernels import fused_round as t_fr  # noqa: E402
from repro_torch.kernels import flash as t_flash  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import pack as t_pack  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.kernels import sort as t_sort  # noqa: E402

from test_torch_cuda import WRAP_ROWS  # noqa: E402

PAD = t_rq.PAD_OFFSET



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only contends with JAX's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _random_sorted(rng, n, cap):
    """Sorted disjoint requests with gaps (test_kernels.py's generator)."""
    gaps = rng.integers(1, 9, size=n)
    lens = rng.integers(1, 6, size=n).astype(np.int32)
    offs = (np.cumsum(gaps) + np.concatenate([[0], np.cumsum(lens)[:-1]])
            ).astype(np.int32)
    o = np.full(cap, PAD, np.int32)
    ln = np.zeros(cap, np.int32)
    o[:n], ln[:n] = offs, lens
    return o, ln


# ----------------------------------------------------------- bitonic_sort

SORT_SWEEP = [(8, 1), (64, 3), (1024, 3), (32768, 2)]


@pytest.mark.parametrize("n,batch", SORT_SWEEP)
def test_bitonic_sort_sweep(n, batch):
    rng = np.random.default_rng(n * 7 + batch)
    offs = rng.integers(0, 1 << 20, size=(batch, n)).astype(np.int32)
    offs[:, 1::2] = offs[:, ::2]                      # duplicate keys
    lens = rng.integers(0, 100, size=(batch, n)).astype(np.int32)
    carry = rng.integers(0, 1 << 20, size=(batch, n)).astype(np.int32)
    so, sl, sc = (_np(x) for x in t_sort.bitonic_sort(_t(offs), _t(lens),
                                                       _t(carry)))
    jo, jl, jc = (np.asarray(x) for x in j_sort.bitonic_sort(
        jnp.asarray(offs), jnp.asarray(lens), jnp.asarray(carry),
        interpret=True))
    np.testing.assert_array_equal(so, jo)
    for b in range(batch):
        # the TPU network orders tied keys arbitrarily: compare the
        # (key, length, carry) multisets with the reference ...
        assert sorted(zip(so[b], sl[b], sc[b])) == sorted(
            zip(jo[b], jl[b], jc[b]))
        # ... and the port exactly with a stable sort
        order = np.argsort(offs[b], kind="stable")
        np.testing.assert_array_equal(sl[b], lens[b][order])
        np.testing.assert_array_equal(sc[b], carry[b][order])


@pytest.mark.parametrize("n", [6, 12, 40000])
def test_bitonic_sort_rejects_bad_block(n):
    x = torch.zeros((1, n), dtype=torch.int32)
    with pytest.raises(ValueError):
        t_sort.bitonic_sort(x, x, x)


def _shuffled(rng, n, cap):
    o, ln = _random_sorted(rng, n, cap)
    starts = np.concatenate([[0], np.cumsum(ln)[:-1]]).astype(np.int32)
    perm = rng.permutation(cap)
    return o, ln, starts, perm


def test_sort_pad_to_pow2():
    rng = np.random.default_rng(0)
    o, ln, starts, perm = _shuffled(rng, 37, 100)   # cap 100 pads to 128
    jr, js = j_ops.sort_requests_with(
        JRequestList(jnp.asarray(o[perm]), jnp.asarray(ln[perm]),
                     jnp.int32(37)), jnp.asarray(starts[perm]))
    tr, ts = t_ops.sort_requests_with(
        t_rq.RequestList(_t(o[perm]), _t(ln[perm]), torch.tensor(37)),
        _t(starts[perm]))
    np.testing.assert_array_equal(_np(tr.offsets), np.asarray(jr.offsets))
    np.testing.assert_array_equal(_np(tr.lengths), np.asarray(jr.lengths))
    np.testing.assert_array_equal(_np(tr.offsets), o)
    # carries of PAD slots are tie-ordered: compare the valid prefix
    np.testing.assert_array_equal(_np(ts)[:37], np.asarray(js)[:37])
    np.testing.assert_array_equal(_np(ts)[:37], starts[:37])


def test_sort_chunked_path(monkeypatch):
    """Lists longer than one block: chunk sort + merge, with MAX_BLOCK
    cut to 64 on both sides."""
    monkeypatch.setattr(j_sort, "MAX_BLOCK", 64)
    monkeypatch.setattr(t_sort, "MAX_BLOCK", 64)
    rng = np.random.default_rng(1)
    o, ln, starts, perm = _shuffled(rng, 150, 200)
    jr, js = j_ops.sort_requests_with(
        JRequestList(jnp.asarray(o[perm]), jnp.asarray(ln[perm]),
                     jnp.int32(150)), jnp.asarray(starts[perm]))
    tr, ts = t_ops.sort_requests_with(
        t_rq.RequestList(_t(o[perm]), _t(ln[perm]), torch.tensor(150)),
        _t(starts[perm]))
    np.testing.assert_array_equal(_np(tr.offsets), np.asarray(jr.offsets))
    np.testing.assert_array_equal(_np(tr.offsets), o)
    np.testing.assert_array_equal(_np(tr.lengths), ln)
    np.testing.assert_array_equal(_np(ts)[:150], np.asarray(js)[:150])


@pytest.mark.parametrize("cap", [200, 256, 333])
def test_sort_chunked_merge_is_stable_sort(monkeypatch, cap):
    """The chunk merge equals a stable argsort, ties and batch included."""
    monkeypatch.setattr(t_sort, "MAX_BLOCK", 64)
    rng = np.random.default_rng(cap)
    offs = rng.integers(0, 50, size=(3, cap)).astype(np.int32)
    carry = np.tile(np.arange(cap, dtype=np.int32), (3, 1))
    tr, ts = t_ops.sort_requests_with(
        t_rq.RequestList(_t(offs), _t(carry), torch.zeros(3,
                                                          dtype=torch.int32)),
        _t(carry))
    order = np.argsort(offs, axis=1, kind="stable")
    np.testing.assert_array_equal(_np(tr.offsets),
                                  np.take_along_axis(offs, order, 1))
    np.testing.assert_array_equal(_np(ts), order)


# ---------------------------------------------------------------- coalesce

def _coalesce_rows(rng, batch, n):
    offs = np.tile(np.arange(n, dtype=np.int32) * 4, (batch, 1))
    gaps = rng.random((batch, n)) < 0.3
    offs = offs + np.cumsum(gaps, axis=1).astype(np.int32) * 2
    lens = np.full((batch, n), 4, np.int32)
    return offs, lens


@pytest.mark.parametrize("n,batch", [(8, 1), (64, 3), (513, 1), (512, 2),
                                     (32768, 2)])
def test_coalesce_kernel_sweep(n, batch):
    rng = np.random.default_rng(n + batch)
    offs, lens = _coalesce_rows(rng, batch, n)
    offs[:, n - n // 4:] = PAD                       # tail padding
    lens[:, n - n // 4:] = 0
    got = [_np(x) for x in t_ck.coalesce(_t(offs), _t(lens))]
    want = [np.asarray(x) for x in j_ck.coalesce(
        jnp.asarray(offs), jnp.asarray(lens), interpret=True)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_coalesce_kernel_interspersed_padding_matches_reference():
    """Pad entries inside a row are run boundaries whose runs count in
    the run ids, exactly as in the TPU kernel."""
    rng = np.random.default_rng(5)
    offs, lens = _coalesce_rows(rng, 2, 64)
    offs[:, 10:14] = PAD
    lens[:, 10:14] = 0
    offs[1, 30] = PAD
    got = [_np(x) for x in t_ck.coalesce(_t(offs), _t(lens))]
    want = [np.asarray(x) for x in j_ck.coalesce(
        jnp.asarray(offs), jnp.asarray(lens), interpret=True)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("row", range(len(WRAP_ROWS)))
def test_coalesce_kernel_wraps_ends_as_int32(row):
    offs, lens = (np.array([x], np.int32) for x in WRAP_ROWS[row])
    got = [_np(x) for x in t_ck.coalesce(_t(offs), _t(lens))]
    want = [np.asarray(x) for x in j_ck.coalesce(
        jnp.asarray(offs), jnp.asarray(lens), interpret=True)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_coalesce_sorted_wraps_ends_as_int32():
    from repro_torch.core import coalesce as t_co
    offs, lens = (np.array(x, np.int32) for x in WRAP_ROWS[0])
    got = t_co.coalesce_sorted(t_rq.RequestList(
        _t(offs), _t(lens), torch.tensor(4, dtype=torch.int32)))
    want = j_co.coalesce_sorted(JRequestList(
        jnp.asarray(offs), jnp.asarray(lens), jnp.int32(4)))
    assert int(want.count) == 2 and int(got.count) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("n", [513])
def test_ops_coalesce_matches_reference_and_coalesce_sorted(n):
    rng = np.random.default_rng(n)
    offs, lens = _coalesce_rows(rng, 1, n)
    count = n - 3
    offs[0, count:], lens[0, count:] = PAD, 0
    jr = JRequestList(jnp.asarray(offs[0]), jnp.asarray(lens[0]),
                      jnp.int32(count))
    tr = t_rq.RequestList(_t(offs[0]), _t(lens[0]), torch.tensor(count))
    got = t_ops.coalesce(tr)
    for want in (j_ops.coalesce(jr), j_co.coalesce_sorted(jr)):
        np.testing.assert_array_equal(_np(got.offsets),
                                      np.asarray(want.offsets))
        np.testing.assert_array_equal(_np(got.lengths),
                                      np.asarray(want.lengths))
        assert int(got.count) == int(want.count)


# ---------------------------------------------------------- fused_sort_pack

def _drain_list(rng, cap, n, base, dup=0):
    """An unsorted drain list: n disjoint requests at or after ``base``
    (the first ``dup`` repeated with identical payload, the only
    deterministic overlap), shuffled among PAD slots."""
    o, ln = _random_sorted(rng, n, n)
    o = o + base
    starts = np.concatenate([[0], np.cumsum(ln)[:-1]]).astype(np.int32)
    o = np.concatenate([o, o[:dup]])
    ln = np.concatenate([ln, ln[:dup]])
    starts = np.concatenate([starts, starts[:dup]])
    full_o = np.full(cap, PAD, np.int32)
    full_l = np.zeros(cap, np.int32)
    full_s = np.zeros(cap, np.int32)
    slots = rng.permutation(cap)[:len(o)]
    full_o[slots], full_l[slots], full_s[slots] = o, ln, starts
    # the payload stream covers every listed length (pack_data walks
    # that many elements), duplicates included
    data = rng.integers(1, 1 << 30, size=int(ln.sum()) + 7).astype(np.int32)
    return full_o, full_l, full_s, data


@pytest.mark.parametrize("cap,n,dup", [(64, 20, 0), (32768, 2000, 50)])
def test_fused_sort_pack_matches_reference(cap, n, dup):
    rng = np.random.default_rng(cap)
    base = 4096 * 3
    o, ln, st, data = _drain_list(rng, cap, n, base + 17, dup)
    jw, jm = j_fr.fused_sort_pack(jnp.asarray(o), jnp.asarray(ln),
                                  jnp.asarray(st), jnp.asarray(data), base,
                                  8192, interpret=True)
    tw, tm = t_fr.fused_sort_pack(_t(o), _t(ln), _t(st), _t(data), base,
                                  8192)
    np.testing.assert_array_equal(_np(tw), np.asarray(jw))
    np.testing.assert_array_equal(_np(tm), np.asarray(jm))
    assert _np(tm).sum() > 0


def test_fused_sort_pack_batched_and_float():
    """Batched rows with per-row bases equal row-by-row reference calls;
    the mask is 1 in the payload's type."""
    rng = np.random.default_rng(7)
    rows = [_drain_list(rng, 256, 60, 4096 * (i + 1), dup=i)
            for i in range(3)]
    dcap = max(r[3].size for r in rows)
    data = np.stack([np.pad(r[3], (0, dcap - r[3].size)) for r in rows]
                    ).astype(np.float32)
    bases = np.array([4096, 8192, 12288], np.int32)
    tw, tm = t_fr.fused_sort_pack(
        _t(np.stack([r[0] for r in rows])), _t(np.stack([r[1] for r in rows])),
        _t(np.stack([r[2] for r in rows])), _t(data), _t(bases), 4096)
    assert tw.dtype == torch.float32 and tm.dtype == torch.float32
    for i, r in enumerate(rows):
        jw, jm = j_fr.fused_sort_pack(
            jnp.asarray(r[0]), jnp.asarray(r[1]), jnp.asarray(r[2]),
            jnp.asarray(data[i]), int(bases[i]), 4096, interpret=True)
        np.testing.assert_array_equal(_np(tw[i]), np.asarray(jw))
        np.testing.assert_array_equal(_np(tm[i]), np.asarray(jm))


def test_ops_fused_drain_pack_pads_and_slices():
    rng = np.random.default_rng(11)
    o, ln, st, data = _drain_list(rng, 100, 30, 320)
    jr = JRequestList(jnp.asarray(o), jnp.asarray(ln), jnp.int32(30))
    tr = t_rq.RequestList(_t(o), _t(ln), torch.tensor(30))
    jw, jm = j_ops.fused_drain_pack(jr, jnp.asarray(st), jnp.asarray(data),
                                    320, 160)
    tw, tm = t_ops.fused_drain_pack(tr, _t(st), _t(data), 320, 160)
    assert tuple(tw.shape) == (160,)
    np.testing.assert_array_equal(_np(tw), np.asarray(jw))
    np.testing.assert_array_equal(_np(tm), np.asarray(jm))


@pytest.mark.parametrize("bad", ["cap", "out_len"])
def test_fused_sort_pack_rejects_bad_shapes(bad):
    cap = 48 if bad == "cap" else 64
    x = torch.zeros((1, cap), dtype=torch.int32)
    with pytest.raises(ValueError):
        t_fr.fused_sort_pack(x, x, x, torch.zeros((1, 8), dtype=torch.int32),
                             0, 4096 if bad == "cap" else 100)


# ------------------------------------------------------------------ pack

@pytest.mark.parametrize("n,cap,seed", [(1, 1, 0), (5, 8, 1), (60, 60, 2),
                                        (2000, 3000, 3), (20000, 32768, 4)])
def test_ops_pack_matches_scatter_oracles(n, cap, seed):
    """ops.pack (the plain version on the CPU) equals the reference's
    scatter oracle ``ref.pack_ref`` and ``coalesce.pack_data``."""
    rng = np.random.default_rng(seed)
    o, ln = _random_sorted(rng, n, cap)
    jr = JRequestList(jnp.asarray(o), jnp.asarray(ln), jnp.int32(n))
    starts = np.array(j_co.request_starts(jr))
    data = rng.integers(1, 1 << 30, size=max(int(ln.sum()), 1)
                        ).astype(np.int32)
    out_len = int(o[n - 1]) + int(ln[n - 1]) + 5
    tr = t_rq.RequestList(_t(o), _t(ln), torch.tensor(n))
    got = t_ops.pack(tr, _t(starts), _t(data), 0, out_len)
    assert tuple(got.shape) == (out_len,)
    np.testing.assert_array_equal(
        _np(got), np.asarray(j_ref.pack_ref(o, ln, starts, data, 0,
                                            out_len)))
    np.testing.assert_array_equal(
        _np(got), np.asarray(j_co.pack_data(jr, jnp.asarray(starts),
                                            jnp.asarray(data), out_len)))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_ops_pack_base_window_matches_reference_kernel(dtype):
    """A window that starts inside the requests (base > 0), in both
    payload types: equal to the reference's Pallas pack (interpret mode)
    and its scatter oracle."""
    rng = np.random.default_rng(5)
    o, ln = _random_sorted(rng, 300, 512)
    jr = JRequestList(jnp.asarray(o), jnp.asarray(ln), jnp.int32(300))
    starts = np.array(j_co.request_starts(jr))
    data = rng.integers(1, 1 << 20, size=int(ln.sum())).astype(dtype)
    base, out_len = int(o[100]) + 2, 700
    tr = t_rq.RequestList(_t(o), _t(ln), torch.tensor(300))
    got = t_ops.pack(tr, _t(starts), _t(data), base, out_len)
    assert got.dtype == _t(data).dtype
    want = j_ops.pack(jr, jnp.asarray(starts), jnp.asarray(data), base,
                      out_len, interpret=True)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(
        _np(got), np.asarray(j_ref.pack_ref(o, ln, starts, data, base,
                                            out_len)))


@pytest.mark.parametrize("bad", ["cap", "out_len", "rank"])
def test_pack_rejects_bad_shapes(bad):
    cap = {"cap": 40000}.get(bad, 64)
    x = torch.zeros((cap,), dtype=torch.int32)
    data = torch.zeros((8,), dtype=torch.int32)
    if bad == "rank":
        x = x[None]
    with pytest.raises(ValueError):
        t_pack.pack(x, x, x, data, 0, 100 if bad == "out_len" else 4096)


# ------------------------------------------------- zero_skip_encode/decode

BF16 = np.dtype(jnp.bfloat16)


def _zero_skip_rows(rng, rows, n, dtype):
    """Rows with about half zeros, plus an all-zero and a no-zero row;
    float rows also hold -0.0 (a zero) and NaN (a nonzero)."""
    x = rng.integers(-5, 6, size=(rows, n)) * (rng.random((rows, n)) < 0.5)
    x[0] = 0
    x[1] = np.where(x[1] == 0, 3, x[1])
    if np.dtype(dtype).kind != "f" and dtype != BF16:
        return x.astype(dtype)
    x = x.astype(np.float32) * np.float32(0.75)
    x[2, ::3] = np.float32(-0.0)
    x[2, 1::7] = np.nan
    return x.astype(dtype)


def _zs_t(x):
    """numpy rows to torch; bfloat16 crosses as its bits."""
    x = np.array(x)
    if x.dtype == BF16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _zs_np(x):
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(BF16)
    return x.numpy()


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.uint8, np.int16,
                                   np.float16, BF16],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("rows,n", [(4, 8), (5, 64), (3, 1024)])
def test_zero_skip_encode_decode_match_reference(dtype, rows, n):
    """At every width up to 4 bytes, exactly the Pallas kernels
    (interpret mode) and the reference codec's stable-argsort encode and
    staged-scatter decode, bit for bit (so -0.0 counts as zero and NaN
    payloads survive)."""
    from repro.core.codec import get_codec as j_get_codec
    x = _zero_skip_rows(np.random.default_rng(n + rows), rows, n, dtype)
    tv, tp = (_zs_np(a) for a in t_fr.zero_skip_encode(_zs_t(x)))
    jv, jp = (np.asarray(a) for a in j_fr.zero_skip_encode(
        jnp.asarray(x), interpret=True))
    (cv, cp), _ = j_get_codec("rle").jax_encode(jnp.asarray(x), ())
    for want_v, want_p in ((jv, jp), (np.asarray(cv), np.asarray(cp))):
        assert tv.dtype == want_v.dtype and tp.dtype == want_p.dtype
        assert tv.tobytes() == want_v.tobytes()
        np.testing.assert_array_equal(tp, want_p)
    out = _zs_np(t_fr.zero_skip_decode(_zs_t(tv), _zs_t(tp)))
    jout = np.asarray(j_fr.zero_skip_decode(jnp.asarray(jv),
                                            jnp.asarray(jp), interpret=True))
    cout = np.asarray(j_get_codec("rle").jax_decode((cv, cp)))
    assert out.tobytes() == jout.tobytes() == cout.tobytes()
    # the round trip restores every nonzero and turns -0.0 into +0.0
    want = x.copy()
    want[x == 0] = 0
    assert out.tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", [np.int64, np.float64],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("rows,n", [(4, 8), (3, 8192)])
def test_zero_skip_encode_decode_64_bit(dtype, rows, n):
    """8-byte payloads: JAX runs with 64-bit types off (its kernels would
    see 32-bit values), so these are held against the port's plain
    version (the wrapper's CPU path), the kernels' chunked algorithm and
    a numpy stable partition instead, bit for bit."""
    x = _zero_skip_rows(np.random.default_rng(n), rows, n, dtype)
    x[1, ::5] = np.iinfo(np.int64).min if dtype == np.int64 else -np.inf
    tv, tp = t_fr.zero_skip_encode(_zs_t(x))
    mv, mp = t_ref.zero_skip_encode_chunked_ref(_zs_t(x), t_fr.ENCODE_TILE)
    assert tv.dtype == mv.dtype and torch.equal(tp, mp)
    assert tv.numpy().tobytes() == mv.numpy().tobytes()
    for r in range(rows):
        keep = np.flatnonzero(x[r] != 0)
        want_p = np.full(n, -1, np.int32)
        want_p[:keep.size] = keep
        want_v = np.zeros(n, dtype)
        want_v[:keep.size] = x[r, keep]
        np.testing.assert_array_equal(tp[r].numpy(), want_p)
        assert tv[r].numpy().tobytes() == want_v.tobytes()
    want = x.copy()
    want[x == 0] = 0
    assert t_fr.zero_skip_decode(tv, tp).numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("shape", [(37,), (3, 100), (2, 3, 5)])
def test_ops_rle_zero_skip_pads_and_slices(shape):
    """Odd widths pad to a power of two (pos padding -1) and come back
    with every leading axis, equal to the reference's ops wrappers."""
    x = np.random.default_rng(len(shape)).integers(
        0, 3, size=shape).astype(np.int32)
    tv, tp = t_ops.rle_zero_skip_encode(_t(x))
    jv, jp = j_ops.rle_zero_skip_encode(jnp.asarray(x))
    assert tuple(tv.shape) == tuple(tp.shape) == shape
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    np.testing.assert_array_equal(_np(tp), np.asarray(jp))
    out = t_ops.rle_zero_skip_decode((tv, tp))
    np.testing.assert_array_equal(
        _np(out), np.asarray(j_ops.rle_zero_skip_decode((jv, jp))))
    np.testing.assert_array_equal(_np(out), x)


@pytest.mark.parametrize("bad", ["width", "rank", "pos_shape"])
def test_zero_skip_rejects_bad_shapes(bad):
    x = torch.zeros((2, 48 if bad == "width" else 64), dtype=torch.int32)
    if bad == "rank":
        x = x.reshape(-1)
    if bad != "pos_shape":
        with pytest.raises(ValueError):
            t_fr.zero_skip_encode(x)
    pos = x[..., :32] if bad == "pos_shape" else x
    with pytest.raises(ValueError):
        t_fr.zero_skip_decode(x, pos)


def test_cpu_path_launches_nothing():
    t_kernels.reset_launch_counts()
    x = torch.zeros((1, 64), dtype=torch.int32)
    t_sort.bitonic_sort(x, x, x)
    t_ck.coalesce(x, x)
    t_fr.fused_sort_pack(x, x, x, x, 0, 4096)
    t_fr.zero_skip_decode(*t_fr.zero_skip_encode(x))
    t_pack.pack(x[0], x[0], x[0], x[0], 0, 4096)
    t_pack.route_spans(x, x, x, x, 100)
    q = torch.zeros((1, 64, 2, 16))
    t_flash.flash_attention_fused(q, q, q, block_q=64, block_kv=64)
    t_flash.flash_attention_bwd(q, q, q, q, q)
    assert t_kernels.launch_counts() == {
        "bitonic_sort": 0, "coalesce": 0, "fused_sort_pack": 0,
        "zero_skip_encode": 0, "zero_skip_decode": 0, "pack": 0,
        "route_spans": 0, "flash_attention_fused": 0,
        "flash_attention_bwd": 0}


def test_non_cpu_tensor_never_takes_the_plain_path():
    """A tensor that is not on the CPU reaches its kernel or raises."""
    x = torch.zeros((1, 64), dtype=torch.int32, device="meta")
    for call in (lambda: t_sort.bitonic_sort(x, x, x),
                 lambda: t_ck.coalesce(x, x),
                 lambda: t_fr.fused_sort_pack(x, x, x, x, 0, 4096),
                 lambda: t_fr.zero_skip_encode(x),
                 lambda: t_fr.zero_skip_decode(x, x),
                 lambda: t_pack.pack(x[0], x[0], x[0], x[0], 0, 4096),
                 lambda: t_pack.route_spans(x, x, x, x, 100),
                 lambda: t_flash.flash_attention_fused(
                     *(torch.zeros((1, 64, 2, 16), device="meta"),) * 3,
                     block_q=64, block_kv=64),
                 lambda: t_flash.flash_attention_ragged(
                     *(torch.zeros((1, 5, 2, 16), device="meta"),) * 3),
                 lambda: t_flash.flash_attention_bwd(
                     *(torch.zeros((1, 5, 2, 16), device="meta"),) * 5)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
