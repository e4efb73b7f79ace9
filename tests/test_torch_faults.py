"""Fault injection and degraded-mode recovery in the port, against the
reference: the cases of ``tests/test_faults.py`` run on both packages.

The policy functions (slowdown measurement, evacuation and repair maps,
retry backoff, ``plan_remesh``, request redistribution) return equal
values; the drain's fail-fast torn write leaves the same detectable
partial file; every faulted write (torn window, straggler, dead
aggregator with and without a heartbeat monitor, lost and delayed
messages, a session evacuating a straggler, a trial aborted by a fault,
a resize mid write-loop) gives byte-identical segments, equal
``IOTimings`` (all but the wall-clock ``plan_seconds``) and equal
session decisions in both packages, and the recovered bytes are the
healthy file's. The reference's kill-and-resume case goes through its
checkpoint manager, which the port does not have yet.
"""
import dataclasses
import os
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import io_patterns as j_pat  # noqa: E402
from repro.checkpoint import host_exec as j_exec  # noqa: E402
from repro.checkpoint.host_io import HostCollectiveIO as JIO  # noqa: E402
from repro.core import cost_model as j_cm  # noqa: E402
from repro.core import faults as j_faults  # noqa: E402
from repro.core import session as j_sess  # noqa: E402
from repro.runtime import heartbeat as j_hb  # noqa: E402
from repro.runtime.elastic import plan_remesh as j_remesh  # noqa: E402

from repro_torch.checkpoint import HostCollectiveIO as TIO  # noqa: E402
from repro_torch.checkpoint import host_exec as t_exec  # noqa: E402
from repro_torch.core import cost_model as t_cm  # noqa: E402
from repro_torch.core import faults as t_faults  # noqa: E402
from repro_torch.core import session as t_sess  # noqa: E402
from repro_torch.core.placement import node_of_slot  # noqa: E402
from repro_torch.runtime import heartbeat as t_hb  # noqa: E402
from repro_torch.runtime.elastic import plan_remesh as t_remesh  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


J = SimpleNamespace(IO=JIO, F=j_faults, S=j_sess.IOSession,
                    HB=j_hb.HeartbeatMonitor, M=j_cm.Machine,
                    arb_key=j_sess._arb_key)
T = SimpleNamespace(IO=lambda **kw: TIO(device="cpu", **kw), F=t_faults,
                    S=t_sess.IOSession, HB=t_hb.HeartbeatMonitor,
                    M=t_cm.Machine, arb_key=t_sess._arb_key)


def _file_len(reqs) -> int:
    return max(int((o + ln).max()) for o, ln, _ in reqs if o.size)


def _reference_file(reqs, file_len: int) -> np.ndarray:
    out = np.zeros(file_len, np.uint8)
    for offs, lens, data in reqs:
        starts = np.cumsum(lens) - lens
        for o, ln, s in zip(offs, lens, starts):
            out[o:o + ln] = data[s:s + ln]
    return out


def _segs(path, n):
    return [open(f"{path}.seg{g}", "rb").read() for g in range(n)]


def _fields(t) -> dict:
    return {f.name: getattr(t, f.name) for f in dataclasses.fields(t)
            if f.name != "plan_seconds"}


def _file(io, path, reqs):
    got = io.read_file(path, _file_len(reqs))
    return got.numpy() if isinstance(got, torch.Tensor) else got


def both(scenario, tmp_path):
    """Run ``scenario(pkg, dir)`` on both packages; their observations
    (timings as dicts of fields, segment bytes, values) must be equal."""
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = scenario(J, tmp_path / "j")
    got = scenario(T, tmp_path / "t")
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if dataclasses.is_dataclass(a):
            assert _fields(a) == _fields(b)
        else:
            assert a == b
    return got


# ---------------------------------------------------------------------
# the policy functions
# ---------------------------------------------------------------------

POLICY = [
    ("measure_node_slowdown", ([2.0, 8.0, 0.0], [1e6, 1e6, 0.0]), {}),
    ("measure_node_slowdown", ([0.0, 0.0], [0.0, 0.0]), {}),
    ("evacuation_map", (8, 4, (1.0, 1.2, 1.0, 1.0)), {}),
    ("evacuation_map", (8, 4, (1.0, 6.0, 1.0, 1.0)), {}),
    ("evacuation_map", (8, 4, (1.0,) * 4), dict(dead_nodes=(0,))),
    ("evacuation_map", (6, 3, (1.0, 2.5, 1.0)),
     dict(domain_bytes=[5, 1, 9, 2, 2, 7])),
    ("repair_map", ((0, 1, 2, 3), 2, [1.0, 2.0, 3.0, 4.0], 4, 4), {}),
    ("repair_map", ((1, 0, 3, 2, 5, 4), 3, [3.0, 1.0, 1.0, 5.0, 0.5, 2.0],
                    6, 3), dict(dead_nodes=(2,))),
    ("partial_marker", ("/x/f.seg3",), {}),
]


@pytest.mark.parametrize("i", range(len(POLICY)),
                         ids=[f"{p[0]}{i}" for i, p in enumerate(POLICY)])
def test_policy_functions_equal_the_reference(i):
    name, args, kw = POLICY[i]
    assert getattr(t_faults, name)(*args, **kw) \
        == getattr(j_faults, name)(*args, **kw)


def test_policy_errors_and_backoff_equal_the_reference():
    for pkg in (j_faults, t_faults):
        with pytest.raises(pkg.UnrecoverableFaultError):
            pkg.evacuation_map(4, 2, (1.0, 1.0), dead_nodes=(0, 1))
        with pytest.raises(pkg.UnrecoverableFaultError):
            pkg.repair_map((0, 1), 0, [0.0, 0.0], 2, 1)
    for lost in (1, 3):
        assert t_faults.FaultSpec(retry_timeout_s=1e-3).retry_penalty(lost) \
            == j_faults.FaultSpec(retry_timeout_s=1e-3).retry_penalty(lost)
    assert t_faults.FaultSpec(slow_nodes={1: 0.5}).slowdown(1) == 1.0
    assert t_faults.FaultSpec(dead_aggregator=(0, 0)).any_node_faults


@pytest.mark.parametrize("total,old", [(24, 32), (16, 16), (7, 8)])
def test_plan_remesh_equals_the_reference(total, old):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = j_remesh(total_devices=total, model_parallel=1,
                        old_data_parallel=old)
        got = t_remesh(total_devices=total, model_parallel=1,
                       old_data_parallel=old)
    assert (got.mesh_shape, got.axis_names, got.grad_accum,
            got.unused_devices) == (want.mesh_shape, want.axis_names,
                                    want.grad_accum, want.unused_devices)
    if want.unused_devices:
        with pytest.warns(RuntimeWarning, match="strands"):
            t_remesh(total_devices=total, model_parallel=1,
                     old_data_parallel=old)


@pytest.mark.parametrize("new_ranks", [1, 5, 12])
def test_redistribute_requests_equals_the_reference(new_ranks):
    reqs = j_pat.s3d_pattern(16, n=8)     # ranks past 8 hold nothing
    got = t_faults.redistribute_requests(reqs, new_ranks)
    want = j_faults.redistribute_requests(reqs, new_ranks)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_heartbeat_death_latches_until_revive():
    tm = [0.0]
    hb = t_hb.HeartbeatMonitor(n_hosts=3, timeout_s=1.0,
                               clock=lambda: tm[0])
    assert hb.healthy()
    tm[0] = 2.0
    hb.beat(0)
    hb.beat(1)
    assert hb.dead_hosts() == [2]
    hb.beat(2)
    tm[0] = 2.5
    assert hb.dead_hosts() == [2]
    hb.inject_failure(1)
    hb.beat(1)
    assert hb.dead_hosts() == [1, 2]
    hb.revive(2)
    hb.revive(1)
    assert hb.healthy()


# ---------------------------------------------------------------------
# the drain's fail-fast torn write
# ---------------------------------------------------------------------

def test_write_segment_fails_fast_and_marks_partial(tmp_path):
    cb = 1024
    seg = np.arange(64 * cb, dtype=np.int64).astype(np.uint8)
    out = []
    for name, fn, s in (("j", j_exec.write_segment, seg),
                        ("t", t_exec.write_segment, torch.from_numpy(seg))):
        path = str(tmp_path / name)
        with pytest.raises(t_faults.TornWriteError if name == "t"
                           else j_faults.TornWriteError) as ei:
            fn(path, s, cb, depth=2, fail_after_windows=2)
        assert ei.value.windows_written == 2
        assert ei.value.windows_enqueued < 16
        out.append((os.path.getsize(path),
                    open(t_faults.partial_marker(path)).read()))
        os.remove(t_faults.partial_marker(path))
        fn(path, s, cb, depth=2)
        assert np.array_equal(np.fromfile(path, np.uint8), seg)
    assert out[0] == out[1] == (2 * cb, "windows_written=2\n")


def test_read_file_refuses_torn_segment(tmp_path):
    io = T.IO(n_ranks=16, n_nodes=4, stripe_size=1024, stripe_count=4)
    reqs = j_pat.btio_pattern(16, n=32)
    path = str(tmp_path / "f")
    io.write(reqs, path, method="tam", cb_bytes=1024)
    np.testing.assert_array_equal(_file(io, path, reqs),
                                  _reference_file(reqs, _file_len(reqs)))
    open(t_faults.partial_marker(path + ".seg1"), "w").write(
        "windows_written=0\n")
    with pytest.raises(t_faults.TornWriteError):
        io.read_file(path, _file_len(reqs))
    with pytest.raises(t_faults.TornWriteError):
        io.read([(o, ln) for o, ln, _ in reqs], path, cb_bytes=1024)


# ---------------------------------------------------------------------
# faulted writes on both packages
# ---------------------------------------------------------------------

def _io(pkg, sc=4, **kw):
    return pkg.IO(n_ranks=16, n_nodes=4, stripe_size=1024, stripe_count=sc,
                  **kw)


def _write_obs(io, reqs, path, n_seg, **kw):
    t = io.write(reqs, path, **kw)
    return [t, _segs(path, n_seg),
            bool(np.array_equal(_file(io, path, reqs),
                                _reference_file(reqs, _file_len(reqs))))]


def test_torn_window_injection_detected_and_repaired(tmp_path):
    reqs = j_pat.btio_pattern(16, n=32)

    def scenario(pkg, d):
        obs = _write_obs(_io(pkg), reqs, str(d / "f"), 4, method="tam",
                         cb_bytes=1024, pipeline=True,
                         faults=pkg.F.FaultSpec(torn_window=(1, 1)))
        return obs + [os.path.exists(str(d / "f.seg1.partial"))]

    t, _, ok, marker = both(scenario, tmp_path)
    assert t.torn_writes_detected == 1 and t.recovery_seconds > 0
    assert ok and not marker


def test_slow_node_measured_and_byte_identical(tmp_path):
    reqs = j_pat.e3sm_f_pattern(16)

    def scenario(pkg, d):
        io = _io(pkg, sc=8)
        return (_write_obs(io, reqs, str(d / "h"), 8, method="tam",
                           cb_bytes=1024)
                + _write_obs(io, reqs, str(d / "f"), 8, method="tam",
                             cb_bytes=1024,
                             faults=pkg.F.FaultSpec(slow_nodes={1: 4.0})))

    healthy, _, _, t, _, ok = both(scenario, tmp_path)
    assert ok and t.node_slowdown[1] > 1.5
    assert t.total > healthy.total


def test_session_evacuates_straggler_within_one_write(tmp_path):
    reqs = j_pat.e3sm_f_pattern(16)
    knobs = dict(method="tam", local_aggregators=8, cb_bytes="auto",
                 pipeline_depth="auto", slow_hop_codec=None,
                 placement="auto")

    def scenario(pkg, d):
        m = pkg.M(io_bw=5e7)
        io = _io(pkg, sc=8, machine=m, session=pkg.S(machine=m))
        obs = []
        for i in range(3):
            obs += _write_obs(io, reqs, str(d / f"h{i}"), 8, **knobs)
        slow = pkg.F.FaultSpec(slow_nodes={1: 6.0})
        for i in range(5):
            obs += _write_obs(io, reqs, str(d / f"d{i}"), 8, **knobs,
                              faults=slow)
        return obs + [io.session.hits, io.session.misses,
                      io.session.replans]

    obs = both(scenario, tmp_path)
    faulted = obs[9:24:3]
    assert all(obs[2:24:3])
    assert faulted[1].serve_map is not None
    assert all(node_of_slot(s, 8, 4) != 1 for s in faulted[-1].serve_map)


def test_dead_aggregator_recovers_byte_identical(tmp_path):
    reqs = j_pat.btio_pattern(16, n=32)

    def scenario(pkg, d):
        hb = pkg.HB(n_hosts=4, timeout_s=5e-3, clock=lambda: 0.0)
        obs = _write_obs(_io(pkg), reqs, str(d / "f"), 4, method="tam",
                         cb_bytes=1024, pipeline=True,
                         faults=pkg.F.FaultSpec(dead_aggregator=(2, 1)),
                         heartbeat=hb)
        return obs + [hb.dead_hosts(),
                      os.path.exists(str(d / "f.seg2.partial"))]

    t, _, ok, dead, marker = both(scenario, tmp_path)
    assert dead == [node_of_slot(2, 4, 4)]
    assert t.repair_map[2] != 2 and t.torn_writes_detected >= 1
    assert ok and not marker


@pytest.mark.parametrize("method", ["tam", "twophase"])
def test_dead_aggregator_without_heartbeat(tmp_path, method):
    reqs = j_pat.btio_pattern(16, n=32)

    def scenario(pkg, d):
        return _write_obs(_io(pkg), reqs, str(d / "f"), 4, method=method,
                          cb_bytes=1024,
                          faults=pkg.F.FaultSpec(dead_aggregator=(0, 0),
                                                 detection_s=0.25))

    t, _, ok = both(scenario, tmp_path)
    assert ok and t.recovery_seconds >= 0.25


def test_lost_and_delayed_messages(tmp_path):
    reqs = j_pat.btio_pattern(16, n=32)

    def scenario(pkg, d):
        io = _io(pkg)
        obs = (_write_obs(io, reqs, str(d / "h"), 4, method="twophase",
                          cb_bytes=1024)
               + _write_obs(io, reqs, str(d / "f"), 4, method="twophase",
                            cb_bytes=1024,
                            faults=pkg.F.FaultSpec(lost={(0, 0): 2,
                                                         (3, 1): 1},
                                                   delayed={(1, 0): 0.5})))
        with pytest.raises(pkg.F.UnrecoverableFaultError) as ei:
            io.write(reqs, str(d / "x"), method="twophase", cb_bytes=1024,
                     faults=pkg.F.FaultSpec(lost={(0, 0): 5}))
        return obs + [str(ei.value)]

    healthy, _, _, t, _, ok, _ = both(scenario, tmp_path)
    # sender 3 sends nothing in round 1: only matched losses are retried
    assert t.retries == 2 and ok
    assert t.total >= healthy.total + 0.25


def test_session_trial_abort_unpoisons_entry(tmp_path):
    reqs = j_pat.e3sm_f_pattern(16)
    knobs = dict(method="tam", local_aggregators=8, cb_bytes="auto",
                 pipeline_depth="auto", slow_hop_codec=None,
                 placement="auto")

    def scenario(pkg, d):
        io = _io(pkg, sc=8, session=pkg.S())
        obs = _write_obs(io, reqs, str(d / "a"), 8, **knobs)
        with pytest.raises(pkg.F.UnrecoverableFaultError):
            io.write(reqs, str(d / "b"), **knobs,
                     faults=pkg.F.FaultSpec(lost={(0, 0): 99}))
        (entry,) = io.session._entries.values()
        first = pkg.arb_key(entry.plan, None)
        clean = all(ak in entry.totals or ak == first for ak in entry.plans)
        obs += _write_obs(io, reqs, str(d / "c"), 8, **knobs)
        obs += _write_obs(io, reqs, str(d / "d"), 8, **knobs)
        return obs + [clean]

    t0, _, _, _, _, _, t3, _, ok, clean = both(scenario, tmp_path)
    assert clean and ok
    assert t3.plan_source == "session-hit"
    assert t3.total <= t0.total + 1e-15


def test_apply_resize_mid_loop_byte_identical(tmp_path):
    reqs = j_pat.btio_pattern(16, n=32)

    def scenario(pkg, d):
        io = _io(pkg)
        io.write(reqs, str(d / "w0"), method="tam", cb_bytes=1024)
        with pytest.warns(RuntimeWarning):
            io2, reqs2, plan = pkg.F.apply_resize(io, reqs, (3,))
        obs = _write_obs(io2, reqs2, str(d / "w1"), 4, method="tam",
                         cb_bytes=1024)
        return obs + [(io2.n_ranks, io2.n_nodes, plan.mesh_shape,
                       plan.unused_devices),
                      _segs(str(d / "w0"), 4) == obs[1]]

    _, _, ok, shape, same = both(scenario, tmp_path)
    assert ok and same and shape[0] < 16


def test_apply_resize_consumes_heartbeat_deaths(tmp_path):
    reqs = j_pat.btio_pattern(16, n=32)
    io = _io(T)
    hb = T.HB(n_hosts=4, timeout_s=10.0)
    hb.inject_failure(2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        io2, _, _ = t_faults.apply_resize(io, reqs, (), heartbeat=hb)
    assert io2.n_ranks < io.n_ranks and io2.device == io.device
    with pytest.raises(t_faults.UnrecoverableFaultError):
        t_faults.apply_resize(io, reqs, (0, 1, 2, 3))
