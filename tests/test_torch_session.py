"""``IOSession`` in the port, against the reference: the cases of
``tests/test_session.py`` on both packages.

Each write sequence runs through the port's ``HostCollectiveIO`` (on the
CPU) and the reference's with one session each: the plan sources, the
session's hit / miss / replan counters, every ``IOTimings`` field but the
wall-clock ``plan_seconds``, the compiled plans (field for field) and
the segment bytes are equal. The rank-axis ``compile`` front end caches
as the reference's does. The reference's checkpoint-manager case waits
for the port's checkpoint layer.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _golden_plans import serialize  # noqa: E402

from repro import io_patterns as j_pat  # noqa: E402
from repro.checkpoint.host_io import HostCollectiveIO as JIO  # noqa: E402
from repro.core import session as j_sess  # noqa: E402
from repro.core.domains import FileLayout as JLayout  # noqa: E402
from repro.core.plan import IOConfig as JConfig  # noqa: E402

from repro_torch.checkpoint import HostCollectiveIO as TIO  # noqa: E402
from repro_torch.checkpoint import IOTimings  # noqa: E402
from repro_torch.core import session as t_sess  # noqa: E402
from repro_torch.core.domains import FileLayout as TLayout  # noqa: E402
from repro_torch.core.plan import IOConfig as TConfig  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


AUTOS = dict(method="tam", local_aggregators=8, cb_bytes="auto",
             pipeline_depth="auto", slow_hop_codec="auto",
             placement="auto")


def _io(pkg, session, stripe_count=4):
    kw = dict(n_ranks=16, n_nodes=4, stripe_size=1024,
              stripe_count=stripe_count, session=session)
    return JIO(**kw) if pkg == "j" else TIO(device="cpu", **kw)


def _segs(path, n):
    return [open(f"{path}.seg{g}", "rb").read() for g in range(n)]


def run_both(tmp_path, writes, stripe_count=4):
    """``writes``: ``[(name, rank_requests, knobs)]`` through one
    session per package; everything observable must be equal."""
    obs = {}
    for pkg, sess_cls in (("j", j_sess.IOSession), ("t", t_sess.IOSession)):
        (tmp_path / pkg).mkdir()
        io = _io(pkg, sess_cls(), stripe_count)
        ts = [io.write(reqs, str(tmp_path / pkg / name), **kw)
              for name, reqs, kw in writes]
        entries = [(e.writes, e.refined, len(e.plans), sorted(
            map(repr, e.totals)), e.executor)
            for e in io.session._entries.values()]
        plans = [serialize(e.best_plan())
                 for e in io.session._entries.values()]
        obs[pkg] = (ts, [_segs(tmp_path / pkg / n, stripe_count)
                         for n, _, _ in writes],
                    (io.session.hits, io.session.misses,
                     io.session.replans), entries, plans, io)
    (tj, sj, cj, ej, pj, _), (tt, st, ct, et, pt, io) = obs["j"], obs["t"]
    for a, b in zip(tt, tj):
        for f in dataclasses.fields(b):
            if f.name != "plan_seconds":
                assert getattr(a, f.name) == getattr(b, f.name), f.name
    assert st == sj and ct == cj and et == ej and pt == pj
    return tt, io


def test_cache_hit_on_identical_layout_and_config(tmp_path):
    reqs = j_pat.e3sm_g_pattern(16)
    ts, io = run_both(tmp_path, [(f"w{i}", reqs, AUTOS) for i in range(4)])
    assert ts[0].plan_source == "compiled"
    assert ts[-1].plan_source == "session-hit"
    assert io.session.misses == 1 and io.session.hits == 3


def test_replan_on_layout_change(tmp_path):
    _, io = run_both(tmp_path, [
        ("a", j_pat.e3sm_g_pattern(16), AUTOS),
        ("b", j_pat.btio_pattern(16, n=32), AUTOS),
        ("c", j_pat.e3sm_g_pattern(16), {**AUTOS, "slow_hop_codec": None})])
    assert io.session.misses == 3


@pytest.mark.parametrize("pattern", ["btio", "e3sm_f", "sparse"])
def test_measured_feedback_monotone(tmp_path, pattern):
    reqs = {"btio": lambda: j_pat.btio_pattern(16, n=32),
            "e3sm_f": lambda: j_pat.e3sm_f_pattern(16),
            "sparse": lambda: j_pat.sparse_checkpoint_pattern(16)}[pattern]()
    ts, io = run_both(tmp_path, [(f"w{i}", reqs, AUTOS) for i in range(4)],
                      stripe_count=8)
    totals = [t.total for t in ts]
    assert totals[2] <= totals[0] + 1e-15
    assert totals[3] <= totals[0] + 1e-15
    assert io.session.hits >= 2


def test_session_reuse_is_byte_identical(tmp_path):
    reqs = j_pat.btio_pattern(16, n=32)
    file_len = int(max((o + ln).max() for o, ln, _ in reqs if o.size))
    run_both(tmp_path, [(f"s{i}", reqs, AUTOS) for i in range(3)],
             stripe_count=8)
    fresh = _io("t", None, 8)
    fresh.write(reqs, str(tmp_path / "fresh"), **AUTOS)
    ref = fresh.read_file(str(tmp_path / "fresh"), file_len)
    for i in range(3):
        assert torch.equal(fresh.read_file(str(tmp_path / "t" / f"s{i}"),
                                           file_len), ref)


def test_session_trial_reverts_when_worse(tmp_path):
    reqs = j_pat.e3sm_g_pattern(16)
    kw = dict(method="twophase", cb_bytes=1024, placement="auto")
    ts, _ = run_both(tmp_path, [(n, reqs, kw) for n in "abc"],
                     stripe_count=8)
    assert ts[2].total <= min(ts[0].total, ts[1].total) + 1e-15
    assert ts[2].plan_source == "session-hit"


def test_reads_drive_the_same_protocol(tmp_path):
    reqs = j_pat.sparse_checkpoint_pattern(16)
    rd = [(o, ln) for o, ln, _ in reqs]
    out = {}
    for pkg, sess_cls in (("j", j_sess.IOSession), ("t", t_sess.IOSession)):
        io = _io(pkg, sess_cls())
        cfg = (JConfig if pkg == "j" else TConfig)(
            req_cap=0, data_cap=0, cb_buffer_size="auto", pipeline=True,
            pipeline_depth="auto", placement="auto")
        io.write(reqs, str(tmp_path / pkg), method="tam", config=cfg)
        ts = [io.read(rd, str(tmp_path / pkg), method="tam", config=cfg,
                      fingerprint=7)[1] for _ in range(3)]
        out[pkg] = ([(t.plan_source, t.total, t.comm_rounds) for t in ts],
                    (io.session.hits, io.session.misses))
    assert out["t"] == out["j"]


def _compile_both(cfg_kw, **kw):
    out = []
    for sess, layout, cfg in ((j_sess.IOSession(), JLayout, JConfig),
                              (t_sess.IOSession(), TLayout, TConfig)):
        lay = layout(stripe_size=1024, stripe_count=4, file_len=1 << 16)
        c = cfg(req_cap=64, data_cap=4096, **cfg_kw)
        out.append((sess, lay, c))
    return out


def test_iosession_compile_front_end():
    kw = dict(n_aggregators=4, n_nodes=4, n_ranks=16)
    plans = []
    for sess, lay, cfg in _compile_both(dict(
            cb_buffer_size=4096, pipeline=True, pipeline_depth=2)):
        p1 = sess.compile(lay, cfg, **kw)
        assert sess.compile(lay, cfg, **kw) is p1
        assert sess.hits == 1 and sess.misses == 1
        p3 = sess.compile(lay, cfg, n_aggregators=4, n_nodes=4, n_ranks=32)
        assert p3 is not p1 and sess.misses == 2
        plans.append((serialize(p1), serialize(p3)))
    assert plans[0] == plans[1]


def test_pipeline_output_feeds_cache_key_deterministically():
    kw = dict(n_aggregators=4, n_nodes=4, n_ranks=16)
    knobs = []
    for sess, lay, cfg in _compile_both(dict(
            cb_buffer_size="auto", pipeline=True, pipeline_depth="auto",
            slow_hop_codec="auto", placement="auto")):
        p1 = sess.compile(lay, cfg, **kw)
        assert sess.compile(lay, cfg, **kw) is p1 and sess.hits == 1
        fused = dataclasses.replace(cfg, kernel_fusion="fused_round")
        p3 = sess.compile(lay, fused, **kw)
        assert p3 is not p1 and sess.misses == 2
        assert p3.kernel_fusion == "fused_round"
        assert dataclasses.replace(p3, kernel_fusion=None) == p1
        knobs.append(j_sess._knobs_of(p1))
    assert t_sess._knobs_of is not j_sess._knobs_of
    assert knobs[0] == knobs[1]


def test_executor_switch_invalidates_measured_totals(tmp_path):
    s = t_sess.IOSession()
    io = _io("t", s)
    reqs = j_pat.e3sm_g_pattern(16)
    io.write(reqs, str(tmp_path / "a"), method="twophase", cb_bytes=1024)
    (key,) = list(s._entries)
    entry = s.entry(key)
    assert entry.executor is None and entry.totals
    plan = entry.plan
    fake = IOTimings()
    fake.transport = "mp"
    fake.io = 123.0
    s.observe(key, plan, fake)
    assert entry.executor == "mp"
    assert list(entry.totals.values()) == [pytest.approx(123.0)]
    assert entry.best_knobs == t_sess._arb_key(plan, None)
    back = IOTimings()
    back.io = 1.0
    s.observe(key, plan, back)
    assert entry.executor is None
    assert list(entry.totals.values()) == [pytest.approx(1.0)]
