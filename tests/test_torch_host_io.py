"""The port's host executor against the reference's, on the CPU.

``repro_torch.checkpoint.HostCollectiveIO(device="cpu")`` and
``repro.checkpoint.host_io.HostCollectiveIO`` run the same requests with
the same knobs:

* writes: the four patterns of ``tests/test_host_io.py`` x ``tam`` /
  ``twophase`` / ``auto`` x single shot and cb rounds at depth 1, 2 and
  3 x two placements; ``rle`` on ``sparse_checkpoint_pattern``; backup
  local aggregators. Every ``.seg<g>`` file is byte-identical and every
  ``IOTimings`` field equal (not close), except the wall-clock
  ``plan_seconds``;
* reads of those files: ``read`` (node cache on and off, with and
  without ``rle``) and ``read_file`` byte-identical, the read-side
  timings equal;
* ``domain_image`` on lists with nested overlaps (a request inside an
  earlier, longer one) equals the reference's, which the ``pack``
  kernel alone would not give, and writes with such requests too.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import io_patterns as j_pat  # noqa: E402
from repro.checkpoint import host_exec as j_exec  # noqa: E402
from repro.checkpoint.host_io import HostCollectiveIO as JIO  # noqa: E402
from repro.core.plan import IOConfig as JConfig  # noqa: E402

from repro_torch.checkpoint import HostCollectiveIO as TIO  # noqa: E402
from repro_torch.checkpoint import host_exec as t_exec  # noqa: E402
from repro_torch.core.plan import IOConfig as TConfig  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


P, NODES, STRIPE, SC = 16, 4, 4096, 3
PATTERNS = {
    "e3sm_g": lambda: j_pat.e3sm_g_pattern(P),
    "e3sm_f": lambda: j_pat.e3sm_f_pattern(P),
    "btio": lambda: j_pat.btio_pattern(P, n=32),
    "s3d": lambda: j_pat.s3d_pattern(P, n=16),
}
# (cb_bytes, pipeline, depth): single shot, then cb rounds at depth 1-3
SCHEDULES = {"single": (None, False, 2), "cb_d1": (1024, False, 2),
             "cb_d2": (1024, True, 2), "cb_d3": (2048, True, 3)}
PLACEMENTS = (None, "spread")


def pair(**kw):
    args = dict(n_ranks=P, n_nodes=NODES, stripe_size=STRIPE,
                stripe_count=SC)
    args.update(kw)
    return JIO(**args), TIO(device="cpu", **args)


def configs(**kw):
    return (JConfig(req_cap=0, data_cap=0, **kw),
            TConfig(req_cap=0, data_cap=0, **kw))


def segs(path, n):
    return [open(f"{path}.seg{g}", "rb").read() for g in range(n)]


def assert_timings_equal(got, want):
    for f in dataclasses.fields(want):
        if f.name == "plan_seconds":
            continue
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.total == want.total


def write_both(tmp_path, reqs, method, jcfg, tcfg, **kw):
    jio, tio = pair(**kw.pop("io", {}))
    tj = jio.write(reqs, str(tmp_path / "j"), method=method, config=jcfg,
                   **kw)
    tt = tio.write(reqs, str(tmp_path / "t"), method=method, config=tcfg,
                   **kw)
    assert segs(tmp_path / "t", jio.stripe_count) \
        == segs(tmp_path / "j", jio.stripe_count)
    assert_timings_equal(tt, tj)
    return jio, tio, tj, tt


@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("method", ["tam", "twophase", "auto"])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_write_equals_the_reference(tmp_path, pattern, method, schedule,
                                    placement):
    cb, pipe, depth = SCHEDULES[schedule]
    jcfg, tcfg = configs(cb_buffer_size=cb, pipeline=pipe,
                         pipeline_depth=depth, placement=placement)
    reqs = PATTERNS[pattern]()
    jio, tio, _, tt = write_both(tmp_path, reqs, method, jcfg, tcfg,
                                 local_aggregators=8)
    file_len = max(int((o + ln).max()) for o, ln, _ in reqs if o.size)
    got = tio.read_file(str(tmp_path / "t"), file_len)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(
        got.numpy(), jio.read_file(str(tmp_path / "j"), file_len))


@pytest.mark.parametrize("schedule", ["single", "cb_d2", "cb_d3"])
@pytest.mark.parametrize("method", ["tam", "twophase"])
def test_rle_write_of_sparse_pages_equals_the_reference(tmp_path, method,
                                                        schedule):
    cb, pipe, depth = SCHEDULES[schedule]
    reqs = j_pat.sparse_checkpoint_pattern(P, pages_per_rank=8,
                                           page_bytes=512)
    jcfg, tcfg = configs(cb_buffer_size=cb, pipeline=pipe,
                         pipeline_depth=depth, slow_hop_codec="rle",
                         placement="spread")
    _, _, tj, tt = write_both(tmp_path, reqs, method, jcfg, tcfg)
    assert tt.slow_hop_codec == "rle"
    assert tt.slow_hop_compression_ratio > 1.5


def test_torch_payloads_and_auto_knobs_equal_the_reference(tmp_path):
    """Tensor payloads (not numpy) and every auto knob resolve and write
    as the reference does."""
    reqs = j_pat.sparse_checkpoint_pattern(P, pages_per_rank=4,
                                           page_bytes=1024)
    t_reqs = [tuple(torch.from_numpy(x) for x in r) for r in reqs]
    jcfg, tcfg = configs(cb_buffer_size="auto", pipeline=True,
                         pipeline_depth="auto", slow_hop_codec="auto",
                         placement="auto")
    jio, tio = pair()
    tj = jio.write(reqs, str(tmp_path / "j"), method="auto", config=jcfg)
    tt = tio.write(t_reqs, str(tmp_path / "t"), method="auto", config=tcfg)
    assert segs(tmp_path / "t", SC) == segs(tmp_path / "j", SC)
    assert_timings_equal(tt, tj)


def test_backup_aggregators_equal_the_reference(tmp_path):
    reqs = j_pat.e3sm_g_pattern(P)
    jcfg, tcfg = configs(cb_buffer_size=1024)
    write_both(tmp_path, reqs, "tam", jcfg, tcfg, local_aggregators=4,
               failed_aggregators={0, 4},
               io=dict(stripe_size=2048, stripe_count=2))
    _, tio = pair(stripe_size=2048, stripe_count=2)
    with pytest.raises(RuntimeError, match="no healthy aggregator"):
        tio.write(reqs, str(tmp_path / "c"), method="tam", config=tcfg,
                  local_aggregators=4, failed_aggregators=set(range(P)))


def test_legacy_knobs_warn_and_equal_the_config(tmp_path):
    reqs = j_pat.btio_pattern(P, n=32)
    _, tio = pair()
    with pytest.warns(DeprecationWarning):
        t1 = tio.write(reqs, str(tmp_path / "a"), method="tam",
                       cb_bytes=1024, pipeline_depth=2)
    _, tcfg = configs(cb_buffer_size=1024, pipeline=True, pipeline_depth=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t2 = tio.write(reqs, str(tmp_path / "b"), method="tam", config=tcfg)
    assert segs(tmp_path / "a", SC) == segs(tmp_path / "b", SC)
    assert_timings_equal(t1, t2)


def _read_requests(reqs, seed):
    """Each reader rank asks for a seeded subset of what some rank wrote,
    cut short or shifted by a few bytes."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(len(reqs)):
        o, ln, _ = reqs[(r * 5) % len(reqs)]
        keep = rng.random(o.size) < 0.7
        shift = rng.integers(0, 3, o.size)
        out.append(((o + shift)[keep], np.maximum(ln - 2 * shift, 1)[keep]))
    return out


@pytest.mark.parametrize("codec", [None, "rle"])
@pytest.mark.parametrize("node_cache", [True, False])
@pytest.mark.parametrize("schedule", ["single", "cb_d2"])
def test_read_equals_the_reference(tmp_path, schedule, node_cache, codec):
    cb, pipe, depth = SCHEDULES[schedule]
    reqs = j_pat.sparse_checkpoint_pattern(P, pages_per_rank=8,
                                           page_bytes=512)
    jcfg, tcfg = configs(cb_buffer_size=cb, pipeline=pipe,
                         pipeline_depth=depth, slow_hop_codec=codec,
                         placement="spread")
    jio, tio, _, _ = write_both(tmp_path, reqs, "tam", jcfg, tcfg)
    path = str(tmp_path / "j")
    for seed in (0, 1):
        rd = ([(o, ln) for o, ln, _ in reqs] if seed == 0
              else _read_requests(reqs, seed))
        want, tj = jio.read(rd, path, method="tam", config=jcfg,
                            node_cache=node_cache)
        got, tt = tio.read(rd, path, method="tam", config=tcfg,
                           node_cache=node_cache)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == torch.uint8
            np.testing.assert_array_equal(a.numpy(), b)
        assert_timings_equal(tt, tj)
        assert tt.direction == "read" and tt.node_cache is node_cache
    # every rank gets back what it wrote
    got, _ = tio.read([(o, ln) for o, ln, _ in reqs], path, config=tcfg)
    for a, (_, _, d) in zip(got, reqs):
        np.testing.assert_array_equal(a.numpy(), d)


def test_read_file_ranges_equal_the_reference(tmp_path):
    reqs = j_pat.btio_pattern(P, n=32)
    jcfg, tcfg = configs(cb_buffer_size=1024)
    jio, tio, _, _ = write_both(tmp_path, reqs, "twophase", jcfg, tcfg)
    for off, n in ((0, None), (100, 5000), (4090, 9), (30000, 10 ** 6)):
        np.testing.assert_array_equal(
            tio.read_file(str(tmp_path / "j"), 32768, offset=off,
                          nbytes=n).numpy(),
            jio.read_file(str(tmp_path / "j"), 32768, offset=off,
                          nbytes=n))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_coalesce_equals_the_reference(seed):
    """Senders with overlapping, duplicate and contiguous requests, one
    with none: offsets, lengths, packed payload and comparison count."""
    rng = np.random.default_rng(seed)
    reqs = []
    for s in range(4):
        n = 0 if s == 2 else int(rng.integers(1, 12))
        lens = rng.integers(1, 40, n).astype(np.int64)
        offs = rng.integers(0, 200, n).astype(np.int64)
        offs[1::3] = offs[0::3][:offs[1::3].size] + lens[0::3][
            :offs[1::3].size]                      # contiguous neighbours
        reqs.append((offs, lens, rng.integers(0, 256, int(lens.sum()))
                     .astype(np.uint8)))
    want = j_exec.merge_coalesce(reqs)
    got = t_exec.merge_coalesce([tuple(torch.from_numpy(x) for x in r)
                                 for r in reqs])
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), b)
    assert got[3] == want[3]


# (offsets, lengths) of one domain's sorted list: nested, duplicate,
# several levels deep, across a stripe round
NESTED = {
    "nested": ([0, 10], [100, 10]),
    "duplicate_shorter": ([0, 0, 40], [30, 10, 5]),
    "two_levels": ([0, 5, 8, 50], [200, 60, 4, 30]),
    "tail_after_nested": ([0, 10, 20], [64, 5, 8]),
    "across_rounds": ([0, 100, 4096 * 3, 4096 * 3 + 7], [4000, 20, 300, 9]),
}


@pytest.mark.parametrize("window", [None, 64, 4096])
@pytest.mark.parametrize("case", sorted(NESTED))
def test_domain_image_of_nested_overlaps_equals_the_reference(case, window):
    offs, lens = (np.asarray(x, np.int64) for x in NESTED[case])
    packed = (np.arange(int(lens.sum())) % 251 + 1).astype(np.uint8)
    want = j_exec.domain_image(offs, lens, packed, 0, 4096, 3)
    got = t_exec.domain_image(torch.from_numpy(offs),
                              torch.from_numpy(lens),
                              torch.from_numpy(packed), 0, 4096, 3,
                              window=window)
    np.testing.assert_array_equal(got.numpy(), want)


def test_domain_image_resolves_nesting_before_the_pack():
    """Fed the nested list unresolved, ``pack`` zeroes the outer
    request's tail: the executor must resolve such lists first."""
    from repro_torch.core.requests import RequestList
    from repro_torch.kernels import ops
    offs, lens = (np.asarray(x, np.int64) for x in NESTED["nested"])
    packed = (np.arange(110) % 251 + 1).astype(np.uint8)
    want = j_exec.domain_image(offs, lens, packed, 0, 4096, 3)
    r = RequestList(torch.tensor(offs, dtype=torch.int32),
                    torch.tensor(lens, dtype=torch.int32),
                    torch.tensor(2, dtype=torch.int32))
    naive = ops.pack(r, torch.tensor([0, 100], dtype=torch.int32),
                     torch.from_numpy(packed), 0, want.size)
    assert not np.array_equal(naive.numpy(), want)
    got = t_exec.domain_image(torch.from_numpy(offs), torch.from_numpy(lens),
                              torch.from_numpy(packed), 0, 4096, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_domain_image_of_nested_overlaps_indexes_no_byte(monkeypatch):
    """Resolving nested requests builds no per-byte index: under a
    ``repeat_index`` / ``byte_index`` that refuse more than 64 positions,
    a nested list of 120 requests over one 4096-byte stripe (each
    ``pack`` call a 64-byte window) still gives the reference's
    image."""
    from repro_torch.core import _tensor
    limit = 64

    def bounded(fn):
        def call(*args):
            out = fn(*args)
            assert out.numel() <= limit, "a byte index past the limit"
            return out
        return call
    monkeypatch.setattr(_tensor, "repeat_index",
                        bounded(_tensor.repeat_index))
    monkeypatch.setattr(_tensor, "byte_index", bounded(_tensor.byte_index))
    monkeypatch.setattr(t_exec, "repeat_index",
                        bounded(_tensor.repeat_index), raising=False)
    rng = np.random.default_rng(11)
    outer = np.arange(0, 3500, 350, dtype=np.int64)
    offs = np.sort(np.concatenate(
        [outer, rng.integers(0, 3500, 110)])).astype(np.int64)
    lens = np.where(np.isin(offs, outer), 500,
                    rng.integers(0, 40, offs.size)).astype(np.int64)
    packed = rng.integers(1, 256, int(lens.sum())).astype(np.uint8)
    assert lens.sum() > 20 * limit
    want = j_exec.domain_image(offs, lens, packed, 0, 4096, 3)
    got = t_exec.domain_image(torch.from_numpy(offs), torch.from_numpy(lens),
                              torch.from_numpy(packed), 0, 4096, 3,
                              window=limit)
    np.testing.assert_array_equal(got.numpy(), want)


def test_write_with_nested_requests_equals_the_reference(tmp_path):
    """Two ranks on one stripe, one request nested in the other's."""
    rng = np.random.default_rng(5)
    reqs = [(np.array([0, 300], np.int64), np.array([200, 50], np.int64),
             rng.integers(1, 255, 250, dtype=np.uint8)),
            (np.array([20, 310], np.int64), np.array([30, 10], np.int64),
             rng.integers(1, 255, 40, dtype=np.uint8))]
    reqs += [(np.zeros(0, np.int64), np.zeros(0, np.int64),
              np.zeros(0, np.uint8))] * 2
    jcfg, tcfg = configs(cb_buffer_size=128, pipeline=True)
    for method in ("tam", "twophase"):
        (tmp_path / method).mkdir()
        write_both(tmp_path / method, reqs, method, jcfg, tcfg,
                   io=dict(n_ranks=4, n_nodes=2, stripe_size=512,
                           stripe_count=2))


def test_domain_image_packs_one_call_per_window_block(monkeypatch):
    """One ``pack`` call per window, and per 32768 requests of a
    window."""
    calls = []
    real = t_exec.ops.pack

    def spy(r, starts, data, base, out_len):
        calls.append((r.capacity, out_len))
        return real(r, starts, data, base, out_len)

    monkeypatch.setattr(t_exec.ops, "pack", spy)
    n = 40000
    offs = torch.arange(n, dtype=torch.int64) * 2
    lens = torch.ones(n, dtype=torch.int64)
    packed = (torch.arange(n) % 200 + 1).to(torch.uint8)
    img = t_exec.domain_image(offs, lens, packed, 0, 1 << 20, 1,
                              window=1 << 16)
    assert calls == [(32768, 65535), (7232, 14463)]
    want = np.zeros(1 << 20, np.uint8)
    want[0:2 * n:2] = packed.numpy()
    np.testing.assert_array_equal(img.numpy(), want)
