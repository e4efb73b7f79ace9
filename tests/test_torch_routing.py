"""The port's routing primitives against the reference's jnp functions.

Inputs are the round-engine check patterns (mixed, strided, overlapping,
spanning, and seeded random) made with numpy and handed to both sides.
The port runs every rank as one row of a batched call; the reference
runs rank by rank. Every comparison is exact: routing moves int32 words
and does no arithmetic on them.
"""
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import coalesce as j_co  # noqa: E402
from repro.core import exchange as j_ex  # noqa: E402
from repro.core import requests as j_rq  # noqa: E402

from repro_torch.core import coalesce as t_co  # noqa: E402
from repro_torch.core import exchange as t_ex  # noqa: E402
from repro_torch.core import requests as t_rq  # noqa: E402


def _import_patterns():
    """rounds_checks sets XLA_FLAGS when imported (it is meant to run as
    its own 8-device process); keep this process's environment as is."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.testing import rounds_checks
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return rounds_checks


rc = _import_patterns()



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only contends with JAX's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _make_patterns():
    rng = np.random.default_rng(0)
    pats = {"mixed": rc.mixed_pattern(rng),
            "strided": rc.strided_pattern(rng),
            "overlapping": rc.overlapping_pattern(rng),
            "spanning": rc.spanning_pattern(rng)}
    for seed in range(4):
        pats[f"random{seed}"] = rc.random_pattern(
            np.random.default_rng(1000 + seed))
    return pats


PATTERNS = _make_patterns()
NAMES = sorted(PATTERNS)


def _t_req(o, ln, c):
    return t_rq.RequestList(torch.as_tensor(np.asarray(o, np.int32)),
                            torch.as_tensor(np.asarray(ln, np.int32)),
                            torch.as_tensor(np.asarray(c, np.int32)))


def _eq(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.dtype == ref.dtype, (port.dtype, ref.dtype)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_array_equal(port, ref)


@functools.lru_cache(maxsize=None)
def _per_rank(fn, *static):
    """The reference function over every rank at once, jit(vmap(fn)),
    with the trailing arguments static; one compile per (fn, static)."""
    return jax.jit(jax.vmap(lambda *args: fn(*args, *static)))


def _j_split_fn(o, ln, c, stripe, spans):
    return j_rq.split_at_stripes(j_rq.RequestList(o, ln, c), stripe, spans)


@functools.lru_cache(maxsize=None)
def _split(name, stripe):
    """Both sides' stripe-split lists of every rank of a pattern."""
    O, L, C, D = PATTERNS[name]
    spans = rc.DATA_CAP // stripe + 2
    t_split = t_rq.split_at_stripes(_t_req(O, L, C), stripe, spans)
    j_split = _per_rank(_j_split_fn, stripe, spans)(
        jnp.asarray(O), jnp.asarray(L), jnp.asarray(C))
    return t_split, j_split, D


@pytest.mark.parametrize("stripe", [32, 80, 160])
@pytest.mark.parametrize("name", NAMES)
def test_split_at_stripes_and_request_starts(name, stripe):
    t_split, j_split, _ = _split(name, stripe)
    _eq(t_split.offsets, j_split.offsets)
    _eq(t_split.lengths, j_split.lengths)
    _eq(t_split.count, j_split.count)
    _eq(t_co.request_starts(t_split),
        _per_rank(j_co.request_starts)(j_split))


@pytest.mark.parametrize("stripe", [32, 80, 4096])
def test_split_at_stripes_wraps_as_int32(stripe):
    """Requests whose ends pass 2^31 - 1, ones in the last stripes below
    it (where the stripe's end passes it) and ones at negative offsets
    split as the reference's int32 arithmetic splits them."""
    big = 2**31 - 1
    rows = [[(big - 40, 30), (big - 5, 10)], [(big - 200, 150)],
            [(-50, 80), (100, 7)], [(big - 2, 2**31 - 1)],
            [(-2**31, 40), (2**31 - 4097, 4097)]]
    O = np.full((len(rows), 4), big, np.int32)
    L = np.zeros_like(O)
    C = np.array([len(r) for r in rows], np.int32)
    for p, reqs in enumerate(rows):
        for i, (o, n) in enumerate(reqs):
            O[p, i], L[p, i] = o, n
    spans = 4
    t_split = t_rq.split_at_stripes(_t_req(O, L, C), stripe, spans)
    j_split = _per_rank(_j_split_fn, stripe, spans)(
        jnp.asarray(O), jnp.asarray(L), jnp.asarray(C))
    _eq(t_split.offsets, j_split.offsets)
    _eq(t_split.lengths, j_split.lengths)
    _eq(t_split.count, j_split.count)


def _j_bucket_fn(o, ln, c, d, n_dest, req_cap, data_cap):
    r = j_rq.RequestList(o, ln, c)
    return j_ex.bucket_by_dest(r, j_co.request_starts(r), d,
                               (o // 32) % n_dest, n_dest, req_cap, data_cap)


@functools.lru_cache(maxsize=None)
def _buckets(name, n_dest, req_cap, data_cap):
    """bucket_by_dest on the 32-split lists of every rank, both sides,
    with the destination (offset // 32) % n_dest."""
    t_split, j_split, D = _split(name, 32)
    t_b = t_ex.bucket_by_dest(
        t_split, t_co.request_starts(t_split), torch.as_tensor(D),
        (t_split.offsets // 32) % n_dest, n_dest, req_cap, data_cap)
    j_b = _per_rank(_j_bucket_fn, n_dest, req_cap, data_cap)(
        j_split.offsets, j_split.lengths, j_split.count, jnp.asarray(D))
    return t_b, j_b


# (n_dest, req_cap, data_cap): roomy, and tight enough to drop
BUCKET_CAPS = [(2, 32, 64), (3, 2, 12)]


@pytest.mark.parametrize("caps", BUCKET_CAPS, ids=["roomy", "tight"])
@pytest.mark.parametrize("name", NAMES)
def test_bucket_by_dest_with_drop_stats(name, caps):
    t_b, j_b = _buckets(name, *caps)
    for field in j_b._fields:
        _eq(getattr(t_b, field), getattr(j_b, field))


@pytest.mark.parametrize("caps", BUCKET_CAPS, ids=["roomy", "tight"])
@pytest.mark.parametrize("name", NAMES)
def test_bucket_by_dest_spans_with_drop_stats(name, caps, monkeypatch):
    """The card's path of bucket_by_dest (the element routing as one
    span a request, here through ``route_spans``' plain version) equals
    the reference, drop stats included."""
    monkeypatch.setattr(t_ex, "_routes_on_kernel", lambda *_: True)
    n_dest, req_cap, data_cap = caps
    t_split, _, D = _split(name, 32)
    t_b = t_ex.bucket_by_dest(
        t_split, t_co.request_starts(t_split), torch.as_tensor(D),
        (t_split.offsets // 32) % n_dest, n_dest, req_cap, data_cap)
    _, j_b = _buckets(name, *caps)
    for field in j_b._fields:
        _eq(getattr(t_b, field), getattr(j_b, field))


def _j_merge_fn(o, ln, c, d):
    r, st, data = j_ex.flatten_buckets(o, ln, c, d)
    sr, ss, sd = j_ex.sort_with(r, st, data[:r.capacity])
    return r, st, data, sr, ss, sd


@functools.lru_cache(maxsize=None)
def _merged(name, caps=(3, 8, 40)):
    """flatten_buckets of each rank's buckets and the sorted merge,
    both sides."""
    t_b, j_b = _buckets(name, *caps)
    t_m = t_ex.flatten_buckets(t_b.offsets, t_b.lengths, t_b.counts,
                               t_b.data)
    j_m = _per_rank(_j_merge_fn)(j_b.offsets, j_b.lengths, j_b.counts,
                                 j_b.data)
    return t_m, j_m


@pytest.mark.parametrize("name", NAMES)
def test_flatten_buckets_and_sort_with(name):
    (t_r, t_st, t_data), (j_r, j_st, j_data, j_sr, j_ss, j_sd) = _merged(name)
    _eq(t_r.offsets, j_r.offsets)
    _eq(t_r.lengths, j_r.lengths)
    _eq(t_r.count, j_r.count)
    _eq(t_st, j_st)
    _eq(t_data, j_data)
    t_sr, t_ss, t_sd = t_ex.sort_with(t_r, t_st, t_data[..., :t_r.capacity])
    _eq(t_sr.offsets, j_sr.offsets)
    _eq(t_sr.lengths, j_sr.lengths)
    _eq(t_ss, j_ss)
    _eq(t_sd, j_sd)


def _sorted(name):
    (t_r, t_st, t_data), (_, _, j_data, j_sr, j_ss, _) = _merged(name)
    t_sr, t_ss = t_ex.sort_with(t_r, t_st)
    return (t_sr, t_ss, t_data), (j_sr, j_ss, j_data)


def _j_repack_fn(o, ln, c, ss, d, out_cap):
    return j_ex.repack_sorted(j_rq.RequestList(o, ln, c), ss, d, out_cap)


def _j_pack_fn(o, ln, c, ss, d, base):
    return j_co.pack_data(j_rq.RequestList(o, ln, c), ss, d, 160, base=base)


def _j_unpack_fn(o, ln, c, ss, buf, base):
    return j_co.unpack_data(j_rq.RequestList(o, ln, c), ss, buf, 48,
                            base=base)


@pytest.mark.parametrize("out_cap", [120, 40])
@pytest.mark.parametrize("name", NAMES)
def test_repack_sorted(name, out_cap):
    (t_sr, t_ss, t_data), (j_sr, j_ss, j_data) = _sorted(name)
    want = _per_rank(_j_repack_fn, out_cap)(
        j_sr.offsets, j_sr.lengths, j_sr.count, j_ss, j_data)
    _eq(t_ex.repack_sorted(t_sr, t_ss, t_data, out_cap), want)


@pytest.mark.parametrize("out_cap", [120, 40])
@pytest.mark.parametrize("name", NAMES)
def test_repack_sorted_spans(name, out_cap, monkeypatch):
    """The card's path of repack_sorted (one span a request, here through
    ``route_spans``' plain version) equals the reference."""
    monkeypatch.setattr(t_ex, "_routes_on_kernel", lambda *_: True)
    (t_sr, t_ss, t_data), (j_sr, j_ss, j_data) = _sorted(name)
    want = _per_rank(_j_repack_fn, out_cap)(
        j_sr.offsets, j_sr.lengths, j_sr.count, j_ss, j_data)
    _eq(t_ex.repack_sorted(t_sr, t_ss, t_data, out_cap), want)


@pytest.mark.parametrize("name", NAMES)
def test_coalesce_sorted(name):
    (t_sr, _, _), (j_sr, _, _) = _sorted(name)
    got = t_co.coalesce_sorted(t_sr)
    want = _per_rank(j_co.coalesce_sorted)(j_sr)
    _eq(got.offsets, want.offsets)
    _eq(got.lengths, want.lengths)
    _eq(got.count, want.count)


@pytest.mark.parametrize("base", [0, 96, 160])
@pytest.mark.parametrize("name", NAMES)
def test_pack_and_unpack_data(name, base):
    """pack_data drops what falls outside the window (positions below
    the base wrap once, as the reference's scatter does); unpack_data
    gathers back out of the written file."""
    (t_sr, t_ss, t_data), (j_sr, j_ss, j_data) = _sorted(name)
    buf = np.arange(1, 321, dtype=np.int32)
    args = (j_sr.offsets, j_sr.lengths, j_sr.count, j_ss)
    want_win = _per_rank(_j_pack_fn, base)(*args, j_data)
    want_back = _per_rank(_j_unpack_fn, base)(
        *args, jnp.broadcast_to(jnp.asarray(buf), (len(j_ss), buf.size)))
    _eq(t_co.pack_data(t_sr, t_ss, t_data, 160, base=base), want_win)
    _eq(t_co.unpack_data(t_sr, t_ss, torch.as_tensor(buf), 48, base=base),
        want_back)


def test_pack_data_per_row_base_matches_scalar_calls():
    (t_sr, t_ss, t_data), _ = _sorted("mixed")
    bases = torch.tensor([0, 32, 64, 96, 128, 160, 0, 32],
                         dtype=torch.int32)
    got = t_co.pack_data(t_sr, t_ss, t_data, 64, base=bases)
    for p in range(len(bases)):
        row = t_rq.RequestList(t_sr.offsets[p], t_sr.lengths[p],
                               t_sr.count[p])
        _eq(got[p], t_co.pack_data(row, t_ss[p], t_data[p], 64,
                                   base=int(bases[p])).numpy())
