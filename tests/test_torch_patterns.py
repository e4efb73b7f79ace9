"""The paper's I/O patterns and the coalesce helpers in the port, against
the reference.

* The five byte-unit generators of ``repro_torch.io_patterns`` equal
  ``repro.io_patterns``'s array for array, across rank counts and seeds.
* ``rank_requests_to_elements`` turns each into the rank-axis executor's
  ``(O, L, C, D)`` exactly (the element file, viewed as bytes, is the
  byte file), and raises on misaligned requests and on files past the
  int32 element range.
* ``merge_sorted``, ``aggregate`` and ``coalesce_ratio`` equal
  ``repro.core.coalesce``'s on seeded per-sender lists, partial counts
  included.
* ``pack_data`` / ``unpack_data`` wrap their int32 file positions as the
  reference does: a request whose ``off + within`` crosses 2^31 - 1, and
  one whose position under a ``base`` wraps.
* Every pattern, converted, goes through both rank-axis writers (fused
  drain, TAM's kernels' plain versions, ``rle`` on the byte payloads)
  and writes ``write_reference``'s file with zero drops.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import io_patterns as j_pat  # noqa: E402
from repro.core import coalesce as j_co  # noqa: E402
from repro.core import requests as j_rq  # noqa: E402
from repro.core.twophase import write_reference as j_write_reference  # noqa: E402,E501

from repro_torch.core import coalesce as t_co  # noqa: E402
from repro_torch.core import requests as t_rq  # noqa: E402
from repro_torch.core.domains import contiguous_layout  # noqa: E402
from repro_torch.core.twophase import write_reference  # noqa: E402
from repro_torch.io_patterns import generators as t_pat  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GENERATORS = {
    "e3sm_g": [dict(n_ranks=4), dict(n_ranks=16, reqs_per_rank=8,
                                     req_bytes=512, seed=5)],
    "e3sm_f": [dict(n_ranks=8), dict(n_ranks=3, seed=9)],
    "btio": [dict(n_ranks=16, n=32), dict(n_ranks=4, n=16, vars_=2,
                                          seed=11)],
    "sparse_checkpoint": [dict(n_ranks=8), dict(
        n_ranks=16, pages_per_rank=16, page_bytes=256,
        zero_page_fraction=0.5, seed=3)],
    "s3d": [dict(n_ranks=8, n=16), dict(n_ranks=10, n=8, seed=4)],
}
CASES = [(name, i) for name, kws in GENERATORS.items()
         for i in range(len(kws))]


def _gen(pkg, name, kw):
    return getattr(pkg, f"{name}_pattern")(**kw)


@pytest.mark.parametrize("name,i", CASES)
def test_generators_equal_the_reference(name, i):
    kw = GENERATORS[name][i]
    want = _gen(j_pat, name, kw)
    got = _gen(t_pat, name, kw)
    assert len(got) == len(want)
    for (go, gl, gd), (wo, wl, wd) in zip(got, want):
        for a, b in ((go, wo), (gl, wl), (gd, wd)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _byte_file(reqs, file_len):
    out = np.zeros(file_len, np.uint8)
    for offs, lens, data in reqs:
        pos = 0
        for o, ln in zip(offs, lens):
            out[o:o + ln] = data[pos:pos + ln]
            pos += ln
    return out


@pytest.mark.parametrize("elem", [np.uint8, np.int32, np.float64])
@pytest.mark.parametrize("name,i", CASES)
def test_converter_gives_the_byte_file_in_elements(name, i, elem):
    reqs = _gen(t_pat, name, GENERATORS[name][i])
    eb = np.dtype(elem).itemsize
    if any(((o % eb) != 0).any() or ((ln % eb) != 0).any()
           for o, ln, _ in reqs):
        with pytest.raises(ValueError, match="whole number"):
            t_pat.rank_requests_to_elements(reqs, elem)
        return
    O, L, C, D = t_pat.rank_requests_to_elements(reqs, elem)
    assert O.dtype == L.dtype == C.dtype == np.int32
    assert D.dtype == np.dtype(elem)
    np.testing.assert_array_equal(C, [o.size for o, _, _ in reqs])
    ext = max(int((o + ln).max()) for o, ln, _ in reqs if o.size)
    layout = contiguous_layout(-(-ext // eb), 1)
    got = write_reference(layout, O, L, C, D).view(np.uint8)
    np.testing.assert_array_equal(got[:ext], _byte_file(reqs, ext))
    # the reference's oracle reads the same arrays the same way
    np.testing.assert_array_equal(
        j_write_reference(layout, O, L, C, D).view(np.uint8), got)
    for p, (o, ln, _) in enumerate(reqs):
        assert (O[p, o.size:] == t_rq.PAD_OFFSET).all()
        assert (L[p, o.size:] == 0).all()


def test_converter_raises_on_misaligned_and_oversized_files():
    ok = [(np.array([0, 8], np.int64), np.array([8, 8], np.int64),
           np.arange(1, 17, dtype=np.uint8))]
    O, L, C, D = t_pat.rank_requests_to_elements(ok, np.int32)
    np.testing.assert_array_equal(O, [[0, 2]])
    np.testing.assert_array_equal(L, [[2, 2]])
    np.testing.assert_array_equal(D.view(np.uint8), ok[0][2][None])
    for offs, lens in (([2, 8], [8, 8]), ([0, 8], [6, 8])):
        bad = [(np.array(offs, np.int64), np.array(lens, np.int64),
                np.ones(16, np.uint8))]
        with pytest.raises(ValueError, match="whole number"):
            t_pat.rank_requests_to_elements(bad, np.int32)
    huge = [(np.array([(2**31 - 2) * 4], np.int64),
             np.array([8], np.int64), np.ones(8, np.uint8))]
    with pytest.raises(ValueError, match="int32 element range"):
        t_pat.rank_requests_to_elements(huge, np.int32)
    # the same file in bytes is too long, in 4-byte elements it is not
    edge = [(np.array([(2**31 - 3) * 4], np.int64),
             np.array([8], np.int64), np.ones(8, np.uint8))]
    assert t_pat.rank_requests_to_elements(edge, np.int32)[0][0, 0] \
        == 2**31 - 3
    with pytest.raises(ValueError, match="int32 element range"):
        t_pat.rank_requests_to_elements(edge, np.uint8)


def _sender_lists(seed, S, cap, full):
    rng = np.random.default_rng(seed)
    O = np.full((S, cap), t_rq.PAD_OFFSET, np.int32)
    L = np.zeros((S, cap), np.int32)
    C = (np.full(S, cap) if full else rng.integers(0, cap + 1, S)) \
        .astype(np.int32)
    for s in range(S):
        # sorted per sender, with contiguous neighbours to coalesce
        lens = rng.integers(1, 6, C[s])
        gaps = rng.integers(0, 2, C[s]) * rng.integers(1, 4, C[s])
        offs = np.cumsum(lens + gaps) - lens + rng.integers(0, 64)
        O[s, :C[s]], L[s, :C[s]] = offs, lens
    return O, L, C


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("seed,S,cap", [(0, 4, 8), (1, 3, 5), (2, 8, 16)])
def test_merge_sorted_aggregate_and_ratio_equal_the_reference(seed, S, cap,
                                                              full):
    O, L, C = _sender_lists(seed, S, cap, full)
    jr = j_rq.RequestList(jnp.asarray(O), jnp.asarray(L), jnp.asarray(C))
    tr = t_rq.RequestList(torch.from_numpy(O), torch.from_numpy(L),
                          torch.from_numpy(C))
    for jf, tf in ((j_co.merge_sorted, t_co.merge_sorted),
                   (j_co.aggregate, t_co.aggregate)):
        want, got = jf(jr), tf(tr)
        for a, b in zip(got, want):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ratio = t_co.coalesce_ratio(t_co.merge_sorted(tr), t_co.aggregate(tr))
    assert ratio.dtype == torch.float32
    np.testing.assert_array_equal(
        ratio.numpy(),
        np.asarray(j_co.coalesce_ratio(j_co.merge_sorted(jr),
                                       j_co.aggregate(jr))))


def test_merge_sorted_takes_a_batch_of_sender_lists():
    lists = [_sender_lists(s, 3, 4, True) for s in range(2)]
    O, L, C = (np.stack([x[i] for x in lists]) for i in range(3))
    got = t_co.aggregate(t_rq.RequestList(*(torch.from_numpy(x)
                                            for x in (O, L, C))))
    for b in range(2):
        one = t_co.aggregate(t_rq.RequestList(
            *(torch.from_numpy(x[b]) for x in (O, L, C))))
        for a, w in zip(got, one):
            np.testing.assert_array_equal(a[b].numpy(), w.numpy())


BIG = 2**31 - 1
# (offsets, lengths, base, payload elements, buffer elements)
WRAP_CASES = {
    "end_crosses_int32": ([BIG - 5], [12], 0, 16, 40),
    "end_crosses_under_base": ([BIG - 5], [12], BIG - 20, 16, 40),
    "negative_wraps_under_base": ([-2**31 + 10], [8], BIG, 16, 40),
    "negative_under_small_base": ([3], [8], 6, 16, 40),
    "mixed_rows": ([0, BIG - 3, 20], [4, 6, 5], 2, 24, 32),
}


@pytest.mark.parametrize("case", sorted(WRAP_CASES))
def test_pack_and_unpack_data_wrap_positions_as_int32(case):
    o, ln, base, dcap, out_len = WRAP_CASES[case]
    O, L = np.array(o, np.int32), np.array(ln, np.int32)
    C = np.int32(len(o))
    D = (np.arange(dcap) + 1).astype(np.int32)
    buf = (np.arange(out_len) + 100).astype(np.int32)
    jr = j_rq.RequestList(jnp.asarray(O), jnp.asarray(L), jnp.asarray(C))
    tr = t_rq.RequestList(torch.from_numpy(O), torch.from_numpy(L),
                          torch.tensor(C))
    js, ts = j_co.request_starts(jr), t_co.request_starts(tr)
    np.testing.assert_array_equal(
        t_co.pack_data(tr, ts, torch.from_numpy(D), out_len, base).numpy(),
        np.asarray(j_co.pack_data(jr, js, jnp.asarray(D), out_len, base)))
    np.testing.assert_array_equal(
        t_co.unpack_data(tr, ts, torch.from_numpy(buf), dcap,
                         base).numpy(),
        np.asarray(j_co.unpack_data(jr, js, jnp.asarray(buf), dcap, base)))


# (pattern, kwargs, element type, codec): every generator, converted,
# through both rank-axis writers with the fused drain
WRITE_CASES = [
    ("e3sm_g", dict(n_ranks=8, reqs_per_rank=16, req_bytes=32), np.int32,
     None),
    ("e3sm_f", dict(n_ranks=8, reqs_per_rank=16, req_bytes=16), np.int32,
     None),
    ("btio", dict(n_ranks=4, n=16), np.int32, None),
    ("s3d", dict(n_ranks=8, n=8), np.int32, None),
    ("sparse_checkpoint", dict(n_ranks=8, pages_per_rank=4,
                               page_bytes=64), np.uint8, "rle"),
    ("e3sm_g", dict(n_ranks=8, reqs_per_rank=16, req_bytes=32), np.uint8,
     "rle"),
]


@pytest.mark.parametrize("method", ["twophase", "tam"])
@pytest.mark.parametrize("i", range(len(WRITE_CASES)))
def test_converted_patterns_write_the_reference_file(i, method):
    from repro_torch.core import (IOConfig, RankMesh, make_tam_write,
                                  make_twophase_write, requests_from_numpy)
    name, kw, elem, codec = WRITE_CASES[i]
    O, L, C, D = t_pat.rank_requests_to_elements(
        _gen(t_pat, name, kw), elem)
    P = O.shape[0]
    mesh = RankMesh(2, 1, P // 2)
    ext = int((O.astype(np.int64) + L).max())
    layout = contiguous_layout(-(-ext // 8) * 8, 2)
    cfg = IOConfig(req_cap=O.shape[1], data_cap=D.shape[1],
                   coalesce_cap=4 * O.shape[1],
                   cb_buffer_size=layout.file_len // 8,
                   kernel_fusion="fused_round", slow_hop_codec=codec)
    write = (make_twophase_write(mesh, layout, cfg, device="cpu")
             if method == "twophase" else
             make_tam_write(mesh, layout, cfg, use_kernels=True,
                            device="cpu"))
    file, stats = write(*requests_from_numpy(O, L, C, D, device="cpu"))
    np.testing.assert_array_equal(file.numpy().reshape(-1),
                                  write_reference(layout, O, L, C, D))
    for k, v in stats.items():
        if k.startswith("dropped"):
            assert int(v.sum()) == 0, k
