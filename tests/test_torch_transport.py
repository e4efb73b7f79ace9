"""The wire format and the multi-process transport in the port.

* Frames: ``pack_pairs``, ``pack_block`` and the combined-frame headers
  are byte-identical to ``repro.core.transport``'s, unpack to what was
  packed, and cross a socketpair whole (``send_msg`` / ``recv_msg``).
* The mp executor (``transport="mp"``, 16 ranks over 4 nodes): segments
  byte-identical to the port's host executor and to the reference's mp
  executor for ``tam`` / ``twophase`` x ``identity`` / ``rle`` x depth
  1 / 2, with the wire's byte counts equal to the reference's; reads
  byte-identical to the host executor's, with the same cache counters;
  an injected dead worker is repaired with identical bytes; the faults
  it cannot honour are refused.
* A session over the mp executor keys on the transport and records the
  executor that measured (only what is deterministic is asserted: the
  wall-clock totals are not).

Every process wait is bounded (``REPRO_MP_TIMEOUT_S``, 60 s).
"""
import socket
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.host_io import HostCollectiveIO as JIO  # noqa: E402
from repro.core import transport as j_tx  # noqa: E402
from repro.core.plan import IOConfig as JConfig  # noqa: E402

from repro_torch.checkpoint import HostCollectiveIO as TIO  # noqa: E402
from repro_torch.core import transport as t_tx  # noqa: E402
from repro_torch.core.faults import FaultSpec  # noqa: E402
from repro_torch.core.plan import IOConfig as TConfig  # noqa: E402
from repro_torch.core.session import IOSession  # noqa: E402
from repro_torch.io_patterns.generators import e3sm_g_pattern  # noqa: E402
from repro_torch.runtime.heartbeat import HeartbeatMonitor  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**40, n).astype(np.int64),
            rng.integers(1, 2**20, n).astype(np.int64))


def test_constants_equal_the_reference():
    for name in ("KIND_BLOCK", "KIND_COMBINED", "KIND_WINDOW",
                 "FLAG_ENCODED", "FRAME_OVERHEAD", "SUB_OVERHEAD",
                 "TRANSPORTS"):
        assert getattr(t_tx, name) == getattr(j_tx, name), name
    assert t_tx.HDR.format == j_tx.HDR.format
    assert t_tx.SUB.format == j_tx.SUB.format


@pytest.mark.parametrize("n", [0, 1, 7])
def test_frames_byte_identical_to_the_reference(n):
    po, pl = _pairs(n, n)
    assert t_tx.pack_pairs(po, pl) == j_tx.pack_pairs(po, pl)
    payload = bytes(range(n * 3))
    for kind in (t_tx.KIND_BLOCK, t_tx.KIND_WINDOW | t_tx.FLAG_ENCODED):
        body = t_tx.pack_block(kind, 5, 2, 9, po, pl, payload, 4 * n)
        assert body == j_tx.pack_block(kind, 5, 2, 9, po, pl, payload,
                                       4 * n)
        k, s, g, r, qo, ql, pay, raw = t_tx.unpack_block(body)
        assert (k, s, g, r, pay, raw) == (kind, 5, 2, 9, payload, 4 * n)
        np.testing.assert_array_equal(qo, po)
        np.testing.assert_array_equal(ql, pl)
    assert t_tx.SUB.pack(1, n, 3, 2) == j_tx.SUB.pack(1, n, 3, 2)


def test_socketpair_round_trip():
    a, b = socket.socketpair()
    try:
        a.settimeout(10)
        b.settimeout(10)
        po, pl = _pairs(3, 5)
        bodies = [t_tx.pack_block(t_tx.KIND_BLOCK, 1, 0, r, po, pl,
                                  bytes([r]) * (1000 * r), 1000 * r)
                  for r in range(4)]
        sent = [t_tx.send_msg(a, body) for body in bodies]
        assert sent == [len(x) + 4 for x in bodies]
        for body in bodies:
            assert t_tx.recv_msg(b) == body
        a.shutdown(socket.SHUT_WR)
        assert t_tx.recv_msg(b) is None          # clean EOF between frames
        c, d = socket.socketpair()
        try:
            c.sendall(t_tx._LEN.pack(10) + b"abc")
            c.shutdown(socket.SHUT_WR)
            d.settimeout(10)
            with pytest.raises(ConnectionError, match="mid-frame"):
                t_tx.recv_msg(d)
        finally:
            c.close()
            d.close()
    finally:
        a.close()
        b.close()


def test_resolve_transport_validation():
    assert t_tx.resolve_transport(None) is None
    assert t_tx.resolve_transport("mp") == "mp"
    with pytest.raises(ValueError, match="rdma"):
        t_tx.resolve_transport("rdma")


P, NODES, STRIPE, SC = 16, 4, 1024, 2


def _reqs():
    return e3sm_g_pattern(P, reqs_per_rank=8, req_bytes=96, seed=4)


def _ios():
    kw = dict(n_ranks=P, n_nodes=NODES, stripe_size=STRIPE, stripe_count=SC)
    return JIO(**kw), TIO(device="cpu", **kw)


REFERENCE_RETRIES = []   # (attempt, message) of each repeated oracle run


def _reference_mp_write(jio, *args, **kw):
    """The reference's mp executor as the oracle. Its acceptor threads
    stop at the first timeout after the workers finish and close their
    listeners with connections still queued, so under load it can lose a
    worker's frames and raise "blocks missing with all workers healthy"
    (the port drains the backlog first). Such a run is repeated, at most
    three times, and each repeat is counted in ``REFERENCE_RETRIES`` and
    reported as a warning; the port's output is compared exactly either
    way."""
    from repro.checkpoint import mp_exec as j_mp
    for attempt in range(3):
        try:
            return jio.write(*args, **kw)
        except j_mp._Failed as e:
            if "blocks missing" not in str(e) or attempt == 2:
                raise
            REFERENCE_RETRIES.append((attempt + 1, str(e)))
            warnings.warn(f"the reference's mp executor lost frames "
                          f"(repeat {len(REFERENCE_RETRIES)} in this "
                          f"test run): {e}", stacklevel=2)


def _segs(path):
    return [open(f"{path}.seg{g}", "rb").read() for g in range(SC)]


def _cfgs(**kw):
    return (JConfig(req_cap=0, data_cap=0, **kw),
            TConfig(req_cap=0, data_cap=0, **kw))


WIRE_FIELDS = ("messages_at_ga", "slow_hop_slow_bytes", "slow_hop_fast_bytes",
               "slow_hop_raw_bytes", "slow_hop_wire_bytes", "node_bytes",
               "rounds_executed", "pipeline_depth", "requests_before",
               "requests_after", "placement", "retries", "transport")


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("codec", ["identity", "rle"])
@pytest.mark.parametrize("method", ["tam", "twophase"])
def test_mp_write_byte_identical(tmp_path, method, codec, depth):
    jio, tio = _ios()
    rr = _reqs()
    kw = dict(cb_buffer_size=256, slow_hop_codec=codec, placement=(1, 0),
              pipeline=depth > 1, pipeline_depth=2)
    jm_cfg, tm_cfg = _cfgs(transport="mp", **kw)
    _, th_cfg = _cfgs(**kw)
    tio.write(rr, str(tmp_path / "h"), method=method, config=th_cfg)
    tm = tio.write(rr, str(tmp_path / "m"), method=method, config=tm_cfg)
    jm = _reference_mp_write(jio, rr, str(tmp_path / "j"), method=method,
                             config=jm_cfg)
    assert tm.transport == "mp"
    assert _segs(tmp_path / "m") == _segs(tmp_path / "h")
    assert _segs(tmp_path / "m") == _segs(tmp_path / "j")
    for f in WIRE_FIELDS:
        assert getattr(tm, f) == getattr(jm, f), f
    assert tm.slow_hop_slow_bytes > t_tx.FRAME_OVERHEAD
    assert len(tm.comm_rounds) == len(tm.io_rounds) == tm.rounds_executed


@pytest.mark.parametrize("node_cache", [True, False])
@pytest.mark.parametrize("codec", [None, "rle"])
def test_mp_read_byte_identical(tmp_path, codec, node_cache):
    _, tio = _ios()
    rr = _reqs()
    _, cfg = _cfgs(cb_buffer_size=256, slow_hop_codec=codec)
    _, mp_cfg = _cfgs(cb_buffer_size=256, slow_hop_codec=codec,
                      transport="mp")
    tio.write(rr, str(tmp_path / "f"), method="tam", config=cfg)
    rd = [(o, ln) for o, ln, _ in rr]
    oh, th = tio.read(rd, str(tmp_path / "f"), config=cfg,
                      node_cache=node_cache)
    om, tm = tio.read(rd, str(tmp_path / "f"), config=mp_cfg,
                      node_cache=node_cache)
    assert tm.transport == "mp"
    for a, b, (_, _, d) in zip(om, oh, rr):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), d)
    for f in ("cache_hits", "cache_misses", "read_bytes", "node_bytes",
              "messages_at_ga", "slow_hop_raw_bytes", "slow_hop_wire_bytes"):
        assert getattr(tm, f) == getattr(th, f), f


@pytest.mark.parametrize("method", ["twophase", "tam"])
def test_killed_worker_is_repaired_byte_identical(tmp_path, method):
    _, tio = _ios()
    rr = _reqs()
    _, cfg = _cfgs(cb_buffer_size=256)
    _, mp_cfg = _cfgs(cb_buffer_size=256, transport="mp")
    tio.write(rr, str(tmp_path / "h"), method=method, config=cfg)
    hb = HeartbeatMonitor(NODES, timeout_s=30.0)
    t = tio.write(rr, str(tmp_path / "m"), method=method, config=mp_cfg,
                  faults=FaultSpec(dead_aggregator=(0, 1)), heartbeat=hb)
    assert hb.dead_hosts() == [0]
    assert t.recovery_seconds > 0.0
    assert _segs(tmp_path / "m") == _segs(tmp_path / "h")


def test_mp_rejects_faults_it_cannot_honour(tmp_path):
    _, tio = _ios()
    rr = _reqs()
    _, mp_cfg = _cfgs(cb_buffer_size=256, transport="mp")
    with pytest.raises(ValueError, match="wall-clock"):
        tio.write(rr, str(tmp_path / "x"), method="twophase", config=mp_cfg,
                  faults=FaultSpec(lost={(0, 0): 1}))
    _, cfg = _cfgs(cb_buffer_size=256)
    tio.write(rr, str(tmp_path / "f"), config=cfg)
    with pytest.raises(ValueError, match="write-side"):
        tio.read([(o, ln) for o, ln, _ in rr], str(tmp_path / "f"),
                 config=mp_cfg, faults=FaultSpec(slow_nodes={0: 2.0}))


def test_session_keys_on_transport_and_records_the_executor(tmp_path):
    sess = IOSession()
    _, tio = _ios()
    tio.session = sess
    rr = _reqs()
    _, mp_cfg = _cfgs(cb_buffer_size=256, transport="mp")
    _, cfg = _cfgs(cb_buffer_size=256)
    t1 = tio.write(rr, str(tmp_path / "a"), method="twophase", config=mp_cfg)
    t2 = tio.write(rr, str(tmp_path / "b"), method="twophase", config=mp_cfg)
    assert t1.plan_source == "compiled"
    assert t2.plan_source in ("session-hit", "session-trial")
    assert t1.transport == t2.transport == "mp"
    (key,) = list(sess._entries)
    entry = sess.entry(key)
    assert entry.executor == "mp"
    assert entry.writes == 2 and len(entry.totals) == 1
    tio.write(rr, str(tmp_path / "c"), method="twophase", config=cfg)
    assert len(sess._entries) == 2
    assert _segs(tmp_path / "a") == _segs(tmp_path / "c")
