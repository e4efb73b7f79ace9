"""The port's checkpoint layer and restart discovery, on the CPU.

Port counterparts of ``tests/test_checkpoint.py``, ``test_restore.py``
and ``test_async_ckpt.py`` (trees of CPU tensors, writers on
``device="cpu"``), the checkpoint-manager cases of ``test_session.py``
and ``test_faults.py`` (a session across saves; kill and resume), and
the cross-package contract: for the same state both packages write the
same manifest JSON and byte-identical ``.seg<g>`` files, and a
checkpoint written by either restores in the other bit for bit.
``find_restart_step`` is run beside the reference's on the same
directories. Every comparison is exact.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.checkpoint import HostCollectiveIO as JIO  # noqa: E402
from repro.checkpoint import restore_checkpoint as j_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro.runtime.elastic import find_restart_step as j_find  # noqa: E402

from repro_torch._tree import leaves, leaves_with_paths, tree_map  # noqa
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    HostCollectiveIO, PendingCheckpoint,
                                    build_manifest, manifest_fingerprint,
                                    restore_checkpoint, save_checkpoint,
                                    snapshot_tree)
from repro_torch.core.faults import (FaultSpec, TornWriteError,  # noqa: E402
                                     UnrecoverableFaultError, apply_resize,
                                     partial_marker)
from repro_torch.core.placement import node_of_slot  # noqa: E402
from repro_torch.core.session import IOSession  # noqa: E402
from repro_torch.data import DataConfig, SyntheticTokenPipeline  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402
from repro_torch.runtime import (HeartbeatMonitor, TrainLoop,  # noqa: E402
                                 TrainLoopConfig, find_restart_step)


def np_tree():
    """The reference tests' tree, as numpy (bf16 as ml_dtypes)."""
    return {"params": {"w": np.arange(640, dtype=np.float32).reshape(8, 80),
                       "b": np.asarray(jnp.full((3,), 2.5, jnp.bfloat16))},
            "opt": {"m": np.asarray(jnp.ones((8, 80), jnp.bfloat16)),
                    "step": np.asarray(np.int32(41))}}


def tree():
    return params_from_numpy(np_tree(), device="cpu")


def _io(n_ranks=8, n_nodes=2, stripe_size=512, stripe_count=4, session=None):
    return HostCollectiveIO(n_ranks=n_ranks, n_nodes=n_nodes,
                            stripe_size=stripe_size,
                            stripe_count=stripe_count, session=session,
                            device="cpu")


def _same(x, y) -> bool:
    """Bit for bit (NaN payloads included)."""
    return x.dtype == y.dtype and x.shape == y.shape and torch.equal(
        x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))


def _assert_tree_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert _same(x, y)


def _zeros_like(t):
    return tree_map(torch.zeros_like, t)


def seg_bytes(directory, stem):
    return [p.read_bytes() for p in sorted(Path(directory).glob(
        f"{stem}.seg*"))]


# ---------------------------------------------------------------------
# test_checkpoint.py
# ---------------------------------------------------------------------
@pytest.mark.parametrize("method", ["tam", "twophase"])
def test_roundtrip(method, tmp_path):
    t = tree()
    save_checkpoint(t, tmp_path / "ck", step=41, io=_io(), method=method,
                    local_aggregators=4)
    got, step = restore_checkpoint(tmp_path / "ck", t)
    assert step == 41
    _assert_tree_equal(t, got)


def test_restore_across_rank_counts(tmp_path):
    t = tree()
    save_checkpoint(t, tmp_path / "ck", io=_io(8, 4, 256, 2), method="tam",
                    local_aggregators=4)
    got, _ = restore_checkpoint(tmp_path / "ck", t)
    assert torch.equal(got["params"]["w"], t["params"]["w"])


def test_manager_rolling_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, _io(4, 2, 256, 2), keep=2)
    t = tree()
    for step in (10, 20, 30):
        mgr.save(t, step)
    assert mgr.latest_step() == 30
    steps = sorted(int(p.name[5:13]) for p in
                   tmp_path.glob("ckpt_*.manifest.json"))
    assert steps == [20, 30]
    _, step = mgr.restore(t)
    assert step == 30


def test_manager_restore_specific_step(tmp_path):
    mgr = CheckpointManager(tmp_path, _io(4, 2, 256, 2), keep=3)
    t = tree()
    mgr.save(t, 10)
    t2 = {"params": {k: v + 1 for k, v in t["params"].items()},
          "opt": t["opt"]}
    mgr.save(t2, 20)
    got10, _ = mgr.restore(t, step=10)
    assert torch.equal(got10["params"]["w"], t["params"]["w"])
    got20, _ = mgr.restore(t, step=20)
    assert torch.equal(got20["params"]["w"], t2["params"]["w"])


# ---------------------------------------------------------------------
# test_restore.py
# ---------------------------------------------------------------------
def _rtree(seed=0):
    rng = np.random.default_rng(seed)
    dense = rng.integers(0, 256, (40, 64), np.uint8).view(np.float32)
    return params_from_numpy(
        {"w": np.asarray(dense, np.float32),
         "b": rng.standard_normal(33).astype(np.float32),
         "opt": {"m": np.zeros((40, 16), np.float32),
                 "v": rng.standard_normal((40, 16)).astype(np.float32)}},
        device="cpu")


def _save(tmp_path, t, io):
    man, _ = save_checkpoint(t, tmp_path / "ck", io=io, method="twophase")
    return man


def _rio(session=None, n_ranks=8, n_nodes=2):
    return _io(n_ranks, n_nodes, 1024, 4, session)


@pytest.mark.parametrize("placement", [None, "spread"])
@pytest.mark.parametrize("codec", [None, "rle"])
@pytest.mark.parametrize("depth", [None, 2])
@pytest.mark.parametrize("node_cache", [True, False])
def test_planned_restore_byte_identical_to_broadcast(
        tmp_path, placement, codec, depth, node_cache):
    t = _rtree()
    io = _rio()
    _save(tmp_path, t, io)
    like = _zeros_like(t)
    oracle, step0 = restore_checkpoint(tmp_path / "ck", like, planned=False)
    got, step = restore_checkpoint(
        tmp_path / "ck", like, io=io, cb_bytes=1024, pipeline_depth=depth,
        slow_hop_codec=codec, placement=placement, node_cache=node_cache)
    assert step == step0
    _assert_tree_equal(oracle, got)
    _assert_tree_equal(t, got)


def test_planned_restore_defaults_and_timings(tmp_path):
    t = _rtree()
    io = _rio()
    man = _save(tmp_path, t, io)
    got, _, tm = restore_checkpoint(tmp_path / "ck", _zeros_like(t), io=io,
                                    with_timings=True)
    _assert_tree_equal(t, got)
    assert tm.direction == "read" and tm.node_cache is True
    assert tm.read_bytes == sum(e["nbytes"] for e in man["leaves"])
    assert tm.cache_hits > 0 and 0.0 < tm.cache_hit_ratio < 1.0
    got, _, tm = restore_checkpoint(tmp_path / "ck", _zeros_like(t),
                                    planned=False, with_timings=True)
    _assert_tree_equal(t, got)
    assert tm is None


@pytest.mark.parametrize("planned", [True, False])
def test_subset_restore_values_and_passthrough(tmp_path, planned):
    t = _rtree()
    io = _rio()
    man = _save(tmp_path, t, io)
    sub = [e["path"] for e in man["leaves"] if "opt" not in e["path"]]
    got, _ = restore_checkpoint(tmp_path / "ck", _zeros_like(t),
                                io=io if planned else None, subset=sub,
                                planned=planned)
    assert _same(got["w"], t["w"]) and _same(got["b"], t["b"])
    assert not got["opt"]["m"].any() and not got["opt"]["v"].any()
    if planned:
        sub_bytes = sum(e["nbytes"] for e in man["leaves"]
                        if e["path"] in set(sub))
        _, _, tm = restore_checkpoint(tmp_path / "ck", _zeros_like(t), io=io,
                                      subset=sub, with_timings=True)
        assert tm.read_bytes == sub_bytes < 0.5 * man["file_len"]


def test_subset_predicate_and_unknown_leaf(tmp_path):
    t = _rtree()
    io = _rio()
    _save(tmp_path, t, io)
    got, _ = restore_checkpoint(tmp_path / "ck", _zeros_like(t), io=io,
                                subset=lambda p: "'b'" in p)
    assert _same(got["b"], t["b"]) and not got["w"].any()
    with pytest.raises(KeyError, match="unknown leaves"):
        restore_checkpoint(tmp_path / "ck", _zeros_like(t), io=io,
                           subset=["nope"])


def test_read_session_steady_state_and_fingerprints(tmp_path):
    t = _rtree()
    sess = IOSession()
    io = _rio(session=sess)
    man1 = _save(tmp_path, t, io)
    like = _zeros_like(t)
    autos = dict(cb_bytes="auto", pipeline_depth="auto", placement="auto",
                 slow_hop_codec="auto")
    totals, sources = [], []
    for _ in range(4):
        got, _, tm = restore_checkpoint(tmp_path / "ck", like, io=io,
                                        with_timings=True, **autos)
        _assert_tree_equal(t, got)
        totals.append(tm.total)
        sources.append(tm.plan_source)
    assert sources[0] == "compiled" and sources[-1] == "session-hit"
    assert totals[-1] <= totals[0] + 1e-15
    d2 = tmp_path / "other"
    man2, _ = save_checkpoint(_rtree(1), d2 / "ck", io=io,
                              method="twophase", step=7)
    assert manifest_fingerprint(man1) != manifest_fingerprint(man2)


def test_manager_restore_subset_and_session(tmp_path):
    t = _rtree()
    sess = IOSession()
    mgr = CheckpointManager(directory=tmp_path / "mgr",
                            io=_rio(session=sess), method="twophase",
                            session=sess)
    for s in range(2):
        mgr.save(t, s)
    got, step, tm = mgr.restore(_zeros_like(t), with_timings=True)
    assert step == 1 and tm.direction == "read"
    _assert_tree_equal(t, got)
    _, _, tm = mgr.restore(_zeros_like(t), with_timings=True)
    assert tm.plan_source in ("session-hit", "session-trial")
    sub, _ = mgr.restore(_zeros_like(t), subset=lambda p: "'w'" in p)
    assert _same(sub["w"], t["w"]) and not sub["b"].any()


def test_restore_refuses_torn_segment(tmp_path):
    t = _rtree()
    io = _rio()
    _save(tmp_path, t, io)
    Path(partial_marker(str(tmp_path / "ck.seg1"))).write_text(
        "windows_written=0\n")
    with pytest.raises(TornWriteError):
        restore_checkpoint(tmp_path / "ck", _zeros_like(t), io=io)
    with pytest.raises(TornWriteError):
        restore_checkpoint(tmp_path / "ck", _zeros_like(t), planned=False)


# ---------------------------------------------------------------------
# test_async_ckpt.py
# ---------------------------------------------------------------------
def test_async_write_byte_identical_to_sync(tmp_path):
    t = tree()
    mgr = CheckpointManager(tmp_path, _io(), method="tam",
                            local_aggregators=4)
    pending = mgr.save_async(t, 10)
    assert isinstance(pending, PendingCheckpoint)
    manifest, tm = pending.result()
    assert pending.done() and manifest["step"] == 10
    assert tm.snapshot_seconds >= 0.0 and tm.drain_wall_seconds > 0.0
    assert 0.0 <= tm.hidden_fraction <= 1.0
    mgr.save(t, 20)
    assert seg_bytes(tmp_path, "ckpt_00000010") == \
        seg_bytes(tmp_path, "ckpt_00000020")
    got, step = mgr.restore(t, step=10)
    assert step == 10
    _assert_tree_equal(t, got)
    stuck = PendingCheckpoint(tmp_path / "never", 0, 0.0)
    with pytest.raises(TimeoutError):
        stuck.wait(timeout=0.01)
    m1, t1 = pending.result()
    m2, t2 = pending.wait()
    assert m1 is m2 and t1 is t2


def test_mutation_after_save_async_does_not_change_bytes(tmp_path):
    """An optimizer that updates in place (the PyTorch idiom) writes into
    the very tensors an async save drains: the snapshot keeps the saved
    bytes."""
    t = tree()
    expected = snapshot_tree(t)
    mgr = CheckpointManager(tmp_path, _io(), method="tam",
                            local_aggregators=4)
    mgr.save_async(t, 10)
    t["params"]["w"].fill_(-1.0)
    t["opt"]["m"].fill_(999.0)
    mgr.block_until_done()
    got, _ = mgr.restore(expected, step=10)
    _assert_tree_equal(expected, got)


def test_snapshot_tree_copies_leaves_to_host():
    t = tree()
    snap = snapshot_tree(t)
    t["params"]["w"][0, 0] = -123.0
    assert snap["params"]["w"][0, 0] == 0.0
    assert all(x.device.type == "cpu" for x in leaves(snap))
    assert snap["params"]["w"].data_ptr() != t["params"]["w"].data_ptr()


def test_failed_async_write_leaves_previous_step_restorable(tmp_path):
    t = tree()
    mgr = CheckpointManager(tmp_path, _io(), method="twophase")
    mgr.save(t, 10)
    good = seg_bytes(tmp_path, "ckpt_00000010")
    pending = mgr.save_async(t, 20, faults=FaultSpec(lost={(0, 0): 99}))
    with pytest.raises(UnrecoverableFaultError):
        pending.wait()
    mgr.block_until_done()       # observed once: quiet now
    assert mgr.latest_step() == 10 and find_restart_step(tmp_path) == 10
    assert not (tmp_path / "ckpt_00000020.manifest.json").exists()
    assert seg_bytes(tmp_path, "ckpt_00000010") == good
    got, step = mgr.restore(t)
    assert step == 10
    _assert_tree_equal(t, got)


def test_unobserved_async_failure_raises_at_next_save(tmp_path):
    t = tree()
    mgr = CheckpointManager(tmp_path, _io(), method="twophase")
    mgr.save_async(t, 10, faults=FaultSpec(lost={(0, 0): 99}))
    with pytest.raises(UnrecoverableFaultError):
        mgr.save(t, 20)
    mgr.save(t, 30)
    assert mgr.latest_step() == 30
    mgr.save_async(t, 40, faults=FaultSpec(lost={(0, 0): 99}))
    with pytest.raises(UnrecoverableFaultError):
        mgr.save_async(t, 50)
    mgr.save_async(t, 60).result()
    assert mgr.latest_step() == 60


def test_interrupted_barrier_keeps_live_future(tmp_path):
    from repro_torch.checkpoint.host_io import IOTimings
    mgr = CheckpointManager(tmp_path, _io(), method="twophase")
    stuck = PendingCheckpoint(tmp_path / "never", 0, 0.0)
    stuck.wait = lambda timeout=None: (_ for _ in ()).throw(
        KeyboardInterrupt())
    mgr.pending = stuck
    with pytest.raises(KeyboardInterrupt):
        mgr.block_until_done()
    assert mgr.pending is stuck
    del stuck.wait
    stuck._finish({"step": 0}, IOTimings())
    mgr.block_until_done()
    assert mgr.pending is None


def test_one_in_flight_session_feedback_and_order(tmp_path):
    t = tree()
    sess = IOSession()
    mgr = CheckpointManager(tmp_path, _io(session=sess), method="tam",
                            local_aggregators=4, session=sess)
    p1 = mgr.save_async(t, 10)
    p2 = mgr.save_async(t, 20)
    assert p1.done() and p2 is mgr.pending
    _, t3 = mgr.save_async(t, 30).result()
    assert t3.plan_source == "session-hit" and sess.hits >= 1
    mgr.save_async(t, 40)
    mgr.save(t, 50)             # barrier first: steps commit in order
    assert mgr.pending is None and mgr.latest_step() == 50


def test_rolling_gc_runs_on_drain_thread(tmp_path):
    t = tree()
    mgr = CheckpointManager(tmp_path, _io(), method="twophase", keep=2)
    for step in (10, 20, 30, 40):
        mgr.save_async(t, step)
    mgr.block_until_done()
    steps = sorted(int(p.name[5:13]) for p in
                   tmp_path.glob("ckpt_*.manifest.json"))
    assert steps == [30, 40]
    assert not list(tmp_path.glob("ckpt_00000010.seg*"))


def test_trainloop_async_checkpoint_end_to_end(tmp_path):
    data = SyntheticTokenPipeline(DataConfig(vocab=64, seq=8,
                                             global_batch=2), device="cpu")

    def train_step(params, opt_state, batch):
        return {"w": params["w"] + 1.0}, opt_state, torch.tensor(0.5)

    mgr = CheckpointManager(tmp_path, _io(), method="tam",
                            local_aggregators=4)
    loop = TrainLoop(TrainLoopConfig(total_steps=9, checkpoint_every=3,
                                     async_checkpoint=True),
                     train_step, data, mgr)
    p_out, _, last = loop.run({"w": torch.zeros((8, 80))},
                              {"s": torch.tensor(0, dtype=torch.int32)})
    assert last == 9 and mgr.pending is None and mgr.latest_step() == 9
    got, step = mgr.restore({"params": {"w": torch.zeros((8, 80))},
                             "opt": {"s": torch.tensor(0,
                                                       dtype=torch.int32)}})
    assert step == 9 and torch.equal(got["params"]["w"], p_out["w"])


# ---------------------------------------------------------------------
# restart discovery, beside the reference's
# ---------------------------------------------------------------------
def _two_steps(tmp_path):
    mgr = CheckpointManager(tmp_path, _io(), method="tam",
                            local_aggregators=4)
    mgr.save(tree(), 10)
    mgr.save(tree(), 20)


def _agree(directory, want):
    assert find_restart_step(directory) == j_find(directory) == want


@pytest.mark.parametrize("case", ["orphan", "partial", "missing_segments",
                                  "zero_length", "empty", "bad_manifest"])
def test_find_restart_step_agrees_with_the_reference(tmp_path, case):
    if case == "empty":
        _agree(tmp_path, None)
        (tmp_path / "ckpt_00000010.seg0").write_bytes(b"orphan")
        _agree(tmp_path, None)
        return
    _two_steps(tmp_path)
    _agree(tmp_path, 20)
    if case == "orphan":     # a drain killed before its commit point
        (tmp_path / "ckpt_00000030.seg0").write_bytes(b"\x00" * 64)
        (tmp_path / "ckpt_00000030.seg1").write_bytes(b"\x00" * 16)
        _agree(tmp_path, 20)
    elif case == "partial":  # a drain torn mid-segment
        marker = tmp_path / "ckpt_00000020.seg0.partial"
        marker.write_text("torn")
        _agree(tmp_path, 10)
        marker.unlink()
        _agree(tmp_path, 20)
    elif case == "missing_segments":
        for seg in tmp_path.glob("ckpt_00000020.seg*"):
            seg.unlink()
        _agree(tmp_path, 10)
    elif case == "zero_length":
        for seg in tmp_path.glob("ckpt_00000020.seg*"):
            seg.write_bytes(b"")
        _agree(tmp_path, 10)
        (tmp_path / "ckpt_00000020.seg0").write_bytes(b"\x01" * 8)
        _agree(tmp_path, 20)
    elif case == "bad_manifest":
        (tmp_path / "ckpt_00000020.manifest.json").write_text("{not json")
        _agree(tmp_path, 10)


def test_kill_and_resume_mid_async_write(tmp_path):
    t = tree()
    sess = IOSession()
    mgr = CheckpointManager(tmp_path, _io(session=sess), method="tam",
                            local_aggregators=4, session=sess)
    mgr.save(t, 10)
    mgr.save_async(t, 20, faults=FaultSpec(lost={(0, 0): 99}))
    mgr.pending._event.wait(30)    # the drain dies before its commit
    mgr2 = CheckpointManager(tmp_path, _io(), method="tam",
                             local_aggregators=4)
    step = find_restart_step(tmp_path)
    assert step == 10 == j_find(tmp_path)
    got, got_step = mgr2.restore(t, step=step)
    assert got_step == 10
    _assert_tree_equal(t, got)


# ---------------------------------------------------------------------
# test_session.py / test_faults.py: the manager across saves
# ---------------------------------------------------------------------
def test_checkpoint_manager_holds_a_session(tmp_path):
    t = params_from_numpy({"w": np.arange(4096, dtype=np.float32),
                           "b": np.ones(1024, np.float32)}, device="cpu")
    mgr = CheckpointManager(directory=tmp_path, io=_io(8, 2, 1024, 4),
                            cb_bytes="auto", pipeline_depth="auto",
                            placement="auto", session=IOSession())
    for step in (1, 2, 3):
        tm = mgr.save(t, step)
    assert mgr.session.hits >= 1
    assert tm.plan_source in ("session-hit", "session-trial")
    got, step = restore_checkpoint(tmp_path / "ckpt_00000003", t)
    assert step == 3
    _assert_tree_equal(t, got)


def test_kill_and_resume_restores_byte_identical(tmp_path):
    rng = np.random.default_rng(11)
    t = params_from_numpy(
        {"w": rng.standard_normal((64, 16)).astype(np.float32),
         "b": rng.standard_normal(64).astype(np.float32),
         "step_scale": np.float32(0.5) * np.ones(8, np.float32)},
        device="cpu")
    hb = HeartbeatMonitor(n_hosts=2, timeout_s=1e-3, clock=lambda: 0.0)
    io = _io(8, 2, 1024, 4)
    mgr = CheckpointManager(directory=tmp_path / "ck", io=io, cb_bytes=1024,
                            heartbeat=hb)
    mgr.save(t, step=0)
    tm = mgr.save(t, step=1, faults=FaultSpec(dead_aggregator=(1, 0)))
    assert tm.recovery_seconds > 0 and tm.repair_map is not None
    dead = hb.dead_hosts()
    assert dead == [node_of_slot(1, 4, 2)]
    empty = [(np.zeros(0, np.int64), np.zeros(0, np.int64),
              np.zeros(0, np.uint8))] * io.n_ranks
    io2, _, _ = apply_resize(io, empty, dead)
    assert io2.n_nodes < io.n_nodes
    mgr2 = CheckpointManager(directory=tmp_path / "ck", io=io2,
                             cb_bytes=1024)
    restored, step = mgr2.restore(like_tree=t)
    assert step == 1
    _assert_tree_equal(t, restored)
    t2 = {k: v + 1 for k, v in t.items()}
    mgr2.save(t2, step=2)
    restored2, _ = mgr2.restore(like_tree=t)
    _assert_tree_equal(t2, restored2)


# ---------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------
def _jio(n_ranks=8, n_nodes=2, stripe_size=512, stripe_count=4):
    return JIO(n_ranks=n_ranks, n_nodes=n_nodes, stripe_size=stripe_size,
               stripe_count=stripe_count)


def _train_state_np():
    """A training state as the reference builds it: reduced gemma2
    parameters and their AdamW state (bf16 moments, int32 step)."""
    from repro import configs as j_configs
    from repro.launch.steps import make_optimizer as j_make_optimizer
    from repro.models import transformer as JT
    from repro.models.config import reduced as j_reduced
    cfg = j_reduced(j_configs.get("gemma2_9b"))
    params = JT.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    opt_state = j_make_optimizer("gemma2_9b").init(params)
    state = {"params": params, "opt": opt_state}
    # nonzero moments, so every byte counts
    state = jax.tree.map(lambda x: x + jnp.ones_like(x) * 0.25
                         if x.dtype != jnp.int32 else x + 3, state)
    return jax.tree.map(np.asarray, state)


@pytest.mark.parametrize("method", ["tam", "twophase"])
@pytest.mark.parametrize("which", ["small", "train_state"])
def test_same_state_same_manifest_and_segments(tmp_path, method, which):
    np_state = np_tree() if which == "small" else _train_state_np()
    j_man, _ = j_save(np_state, tmp_path / "j" / "ck", step=7, io=_jio(),
                      method=method, local_aggregators=4)
    t_man, _ = save_checkpoint(params_from_numpy(np_state, device="cpu"),
                               tmp_path / "t" / "ck", step=7, io=_io(),
                               method=method, local_aggregators=4)
    assert json.dumps(t_man) == json.dumps(j_man)
    assert (tmp_path / "t" / "ck.manifest.json").read_text() == \
        (tmp_path / "j" / "ck.manifest.json").read_text()
    segs = seg_bytes(tmp_path / "t", "ck")
    assert len(segs) == 4 and segs == seg_bytes(tmp_path / "j", "ck")


def test_leaf_paths_and_dtypes_are_the_reference_manifests():
    np_state = _train_state_np()
    flat, _ = jax.tree_util.tree_flatten_with_path(np_state)
    want = [(jax.tree_util.keystr(kp), str(np.asarray(x).dtype))
            for kp, x in flat]
    port = params_from_numpy(np_state, device="cpu")
    got = [(p, e["dtype"]) for (p, _), e in zip(
        leaves_with_paths(port), build_manifest(port)["leaves"])]
    assert got == want
    assert ("['opt']['step']", "int32") in got
    assert ("['opt']['m']['embed']", "bfloat16") in got


@pytest.mark.parametrize("planned", [True, False])
def test_reference_checkpoint_restores_in_the_port(tmp_path, planned):
    np_state = _train_state_np()
    j_save(np_state, tmp_path / "ck", step=5, io=_jio(), method="tam",
           local_aggregators=4)
    want = params_from_numpy(np_state, device="cpu")
    got, step = restore_checkpoint(tmp_path / "ck", _zeros_like(want),
                                   io=_io() if planned else None,
                                   planned=planned)
    assert step == 5
    _assert_tree_equal(want, got)


@pytest.mark.parametrize("planned", [True, False])
def test_port_checkpoint_restores_in_the_reference(tmp_path, planned):
    np_state = _train_state_np()
    save_checkpoint(params_from_numpy(np_state, device="cpu"),
                    tmp_path / "ck", step=6, io=_io(), method="twophase")
    like = jax.tree.map(np.zeros_like, np_state)
    got, step = j_restore(tmp_path / "ck", like,
                          io=_jio() if planned else None, planned=planned)
    assert step == 6
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(np_state)[0],
                            jax.tree.leaves(got)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), jax.tree_util.keystr(path)


def test_manager_directories_are_shared(tmp_path):
    """A reference manager's checkpoints are the port manager's: latest
    step, restore, and the port's next save GC'ing the reference's."""
    np_state = np_tree()
    jm = JManager(tmp_path, _jio(), keep=2)
    jm.save(np_state, 1)
    jm.save(np_state, 2)
    tm = CheckpointManager(tmp_path, _io(), keep=2)
    assert tm.latest_step() == 2
    got, step = tm.restore(tree())
    assert step == 2
    _assert_tree_equal(tree(), got)
    tm.save(tree(), 3)
    assert sorted(int(p.name[5:13]) for p in
                  tmp_path.glob("ckpt_*.manifest.json")) == [2, 3]
    assert jm.latest_step() == 3


# ---------------------------------------------------------------------
# payload streams of checkpoint size: spans and views, no byte index
# ---------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_gather_spans_equals_the_byte_gather(seed, monkeypatch):
    """``gather_spans`` (runs merged, long runs sliced, short ones
    gathered in bounded chunks) gives ``data[byte_index(...)]``; small
    limits make every branch run on a small stream."""
    from repro_torch.core import _tensor
    monkeypatch.setattr(_tensor, "SPAN_SLICE_MIN", 16)
    monkeypatch.setattr(_tensor, "SPAN_GATHER_CHUNK", 40)
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.integers(0, 256, 4096, dtype=np.uint8))
    n = int(rng.integers(1, 200))
    lens = torch.from_numpy(rng.integers(0, 40, n).astype(np.int64))
    starts = torch.from_numpy(rng.integers(0, 4096 - 40, n).astype(np.int64))
    # some spans continue the previous one, to form runs
    cont = torch.from_numpy(rng.random(n) < 0.5)
    for i in range(1, n):
        if cont[i] and starts[i - 1] + lens[i - 1] + 40 < 4096:
            starts[i] = starts[i - 1] + lens[i - 1]
    want = data[_tensor.byte_index(starts, lens)]
    assert torch.equal(_tensor.gather_spans(data, starts, lens), want)


def test_gather_spans_of_one_run_is_a_view():
    from repro_torch.core._tensor import gather_spans
    data = torch.arange(100, dtype=torch.uint8)
    got = gather_spans(data, torch.tensor([10, 30, 50]),
                       torch.tensor([20, 20, 5]))
    assert torch.equal(got, data[10:55])
    assert got.data_ptr() == data[10:].data_ptr()
    assert gather_spans(data, torch.zeros(0, dtype=torch.int64),
                        torch.zeros(0, dtype=torch.int64)).numel() == 0


@pytest.mark.parametrize("seed", range(4))
def test_scatter_spans_inverts_the_byte_gather(seed, monkeypatch):
    """``scatter_spans`` writes ``src`` where ``dst[byte_index(...)] =
    src`` would, through every branch of the span pieces."""
    from repro_torch.core import _tensor
    monkeypatch.setattr(_tensor, "SPAN_SLICE_MIN", 16)
    monkeypatch.setattr(_tensor, "SPAN_GATHER_CHUNK", 40)
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 120))
    lens = rng.integers(0, 40, n).astype(np.int64)
    # disjoint spans in a shuffled order, some continuing the previous
    place = np.cumsum(lens + rng.integers(0, 3, n) * (rng.random(n) < 0.5))
    starts = place - lens
    perm = np.arange(n)
    swap = rng.permutation(n)[: n // 3]
    perm[np.sort(swap)] = swap
    starts, lens = torch.from_numpy(starts[perm]), torch.from_numpy(lens[perm])
    src = torch.from_numpy(rng.integers(0, 256, int(lens.sum()),
                                        dtype=np.uint8))
    want = torch.zeros(int(place[-1]) + 8, dtype=torch.uint8)
    want[_tensor.byte_index(starts, lens)] = src
    got = torch.zeros_like(want)
    _tensor.scatter_spans(got, starts, lens, src)
    assert torch.equal(got, want)
    assert torch.equal(_tensor.gather_spans(got, starts, lens), src)


@pytest.mark.parametrize("codec", [None, "rle"])
def test_save_indexes_no_more_than_a_chunk_of_the_stream(codec, tmp_path,
                                                         monkeypatch):
    """A save, with or without a slow-hop codec, never builds a byte
    index longer than ``SPAN_GATHER_CHUNK`` (here 64 of a stream of
    thousands of bytes), and restores bit for bit."""
    from repro_torch.core import _tensor
    limit = 64
    byte_index = _tensor.byte_index

    def bounded(starts, lengths):
        assert int(lengths.sum()) <= limit, "a byte index past the chunk"
        return byte_index(starts, lengths)
    monkeypatch.setattr(_tensor, "byte_index", bounded)
    monkeypatch.setattr(_tensor, "SPAN_SLICE_MIN", 16)
    monkeypatch.setattr(_tensor, "SPAN_GATHER_CHUNK", limit)
    t = _rtree()
    save_checkpoint(t, tmp_path / "ck", io=_rio(), method="tam",
                    slow_hop_codec=codec)
    got, _ = restore_checkpoint(tmp_path / "ck", _zeros_like(t), io=_rio(),
                                slow_hop_codec=codec)
    _assert_tree_equal(t, got)


def test_cat_views_joins_splits_without_a_copy():
    from repro_torch.core._tensor import cat_views
    stream = torch.arange(64, dtype=torch.uint8)
    parts = list(torch.split(stream, [10, 0, 30, 24]))
    got = cat_views(parts[:3])
    assert torch.equal(got, stream[:40])
    assert got.data_ptr() == stream.data_ptr()
    shuffled = cat_views([parts[2], parts[0]])
    assert torch.equal(shuffled, torch.cat([parts[2], parts[0]]))
    assert shuffled.data_ptr() != stream.data_ptr()
    assert cat_views([], "cpu").numel() == 0


def test_rank_requests_are_one_stream_the_writer_takes_as_is():
    """The checkpoint's per-rank payloads are consecutive slices of one
    stream, and the writer's upload takes them without a copy."""
    from repro_torch.checkpoint.checkpoint import _rank_requests
    t = tree()
    reqs = _rank_requests(t, build_manifest(t), 8)
    io = _io()
    _, _, _, data = io._upload(reqs)
    assert data.data_ptr() == reqs[0][2].data_ptr()
    assert data.numel() == sum(int(d.numel()) for _, _, d in reqs)
