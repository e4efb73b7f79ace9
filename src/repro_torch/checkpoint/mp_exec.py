"""Multi-process transport executor: real processes, real bytes (port
of ``repro.checkpoint.mp_exec``).

The third backend of the plan/executor split (``IOPlan.transport ==
"mp"``, dispatched by ``checkpoint.host_io``). Where the host executor
moves bytes inside one process and CHARGES an alpha-beta model, this
one actually ships them between processes:

* one **worker process per sender** (per ``per_la`` entry — a local
  aggregator under TAM, a rank under two-phase), grouped into "nodes"
  by ``sender_nodes``;
* the **intra-node fast hop** is a per-node
  ``multiprocessing.shared_memory`` arena: a sender co-located with the
  serving aggregator writes its round blocks into its arena region and
  posts only a descriptor — the parent (which maps the same segment)
  consumes the bytes zero-copy;
* the **inter-node slow hop** is a localhost TCP socket per destination
  node (``core.transport`` framing): every cross-node message pays real
  serialization + kernel round trips, so congestion and the
  message-count collapse of intra-node aggregation are measurable as
  wall-clock and wire-byte facts, not model outputs. Under TAM the
  node's elected leader combines all co-located senders' blocks for a
  (domain, round) into ONE frame (subrecords read zero-copy from the
  arena); flat two-phase sends one frame per sender.
* slow-hop codecs run **encode-once on the wire**: the sender encodes,
  the receiver decodes; fast-hop (arena) blocks move raw.

Byte identity is the contract: the parent reassembles the per-domain
inboxes in the host executor's exact sender order and reuses its drain
(``host_exec.drain_images``: merge, coalesce, the ``pack`` kernel on
the executor's device; ``write_segment``), so segments on disk are
byte-identical to ``host_exec.execute_write`` for every placement x
codec x depth (tests/test_torch_transport.py). The read direction mirrors
``execute_read``: the parent performs the ranged window reads, one
elected fetcher per (window, node) receives each window over its
socket, stages it into the node arena, and fans it out to co-located
readers through their queues; per-rank outputs return through a result
arena.

TIME here is real wall-clock: ``IOTimings.comm_rounds`` /
``io_rounds`` / ``inter_comm`` / ``io`` are measured, and feed the same
session ``observe`` loop as modeled timings (``IOTimings.transport``
records which executor produced a measurement — the session discards
totals across an executor switch).

Faults: the only injection this backend honors is
``FaultSpec.dead_aggregator = (sender, round)``, reinterpreted at
process level — worker ``sender`` is killed (``os._exit``) entering
``round``. The parent detects the death (exit code + missing blocks),
latches it on the heartbeat monitor, regenerates the victim's
unfinished blocks from the stage-1 data it already holds (the repair
story), and charges ``recovery_seconds`` — the segments stay
byte-identical to the healthy run. Other ``FaultSpec`` fields model
timing, which is not modeled here, and are rejected loudly.

Workers are forked (start method ``"fork"``): they inherit the stage-1
data and the arena mappings copy-free. The parent may have initialised
CUDA before the fork, and a forked child must not touch it: the
executor copies every tensor it is given to host numpy arrays BEFORE
it forks, so the workers touch only numpy + sockets + queues (never a
device tensor, never torch's CUDA state). The parent alone moves the
reassembled bytes back to the device for the drain. Every blocking wait is bounded by ``WAIT_S``
(``REPRO_MP_TIMEOUT_S``) so a hung worker fails the run fast instead of
wedging it.
"""
from __future__ import annotations

import multiprocessing
import os
import queue as queue_mod
import socket
import struct
import threading
import time
from multiprocessing import shared_memory

import numpy as np

import torch

from repro_torch.checkpoint.host_exec import (drain_images, serve_of,
                                              to_domain_local, write_segment)
from repro_torch.core import placement as placement_mod
from repro_torch.core import transport as tx
from repro_torch.core._tensor import to_host
from repro_torch.core.codec import get_codec
from repro_torch.core.cost_model import optimal_depth
from repro_torch.core.faults import TornWriteError, partial_marker

WAIT_S = float(os.environ.get("REPRO_MP_TIMEOUT_S", "60"))

_KILL_EXIT = 23     # exit code of an injected worker kill


def _ctx():
    try:
        return multiprocessing.get_context("fork")
    except ValueError as e:  # pragma: no cover - non-POSIX platforms
        raise RuntimeError(
            "the mp transport needs the 'fork' start method (workers "
            "inherit stage-1 arrays and arena mappings)") from e


def _serve_of(plan, serve_map, stripe_count, n_nodes):
    """The domain->slot map and its node image (host_exec semantics)."""
    serve = serve_of(plan, serve_map, stripe_count)
    serve_nodes = [placement_mod.node_of_slot(serve[g], stripe_count,
                                              n_nodes)
                   for g in range(stripe_count)]
    return serve, serve_nodes


def _sender_schedule(offs, lens, packed, stripe_size, stripe_count, cb):
    """One sender's per-(domain, round) blocks, in the host oracle's
    exact partition: a request belongs to domain ``(off//ss) % sc`` and
    round ``to_domain_local(off) // cb`` (host_exec's per-sender loop).

    Returns ``[(g, po, pl, seg_starts, {round: (in_r, payload)})]``,
    domains ascending, with ``payload`` the round's packed byte slice.
    """
    owner = (offs // stripe_size) % stripe_count
    rnd = to_domain_local(offs, stripe_size, stripe_count) // cb
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    per_g = []
    for g in range(stripe_count):
        sel = owner == g
        if not sel.any():
            continue
        po, pl = offs[sel], lens[sel]
        pd = (np.concatenate([packed[s:s + l]
                              for s, l in zip(starts[sel], pl)])
              if int(pl.sum()) else np.zeros(0, np.uint8))
        seg_starts = np.concatenate([[0], np.cumsum(pl)[:-1]])
        rounds = {}
        for r in np.unique(rnd[sel]):
            in_r = rnd[sel] == r
            payload = (np.concatenate(
                [pd[s:s + l] for s, l in zip(seg_starts[in_r], pl[in_r])])
                if int(pl[in_r].sum()) else np.zeros(0, np.uint8))
            rounds[int(r)] = (in_r, payload)
        per_g.append((int(g), po, pl, seg_starts, rounds))
    return per_g


def _round_walls(arrival: dict, n_rounds: int, t0: float):
    """Per-round wall-clock increments from last-arrival timestamps."""
    dur = [0.0] * n_rounds
    prev = t0
    for r in range(n_rounds):
        end = arrival.get(r)
        if end is not None and end > prev:
            dur[r] = end - prev
            prev = end
    return dur


class _Failed(RuntimeError):
    """A worker process died without fault injection to excuse it."""


def execute_write(plan, machine, per_la, path, t, depth_request=None,
                  sender_nodes=None, n_nodes=None, faults=None,
                  heartbeat=None, serve_map=None):
    """Run a write plan's exchange + I/O on real worker processes.

    Same signature and byte contract as
    :func:`repro_torch.checkpoint.host_exec.execute_write`; see the
    module docstring for what is real here. ``plan.method == "tam"``
    selects node-combined slow-hop frames (the senders ARE the stage-1
    local aggregators); two-phase sends per-sender frames.
    """
    m = machine
    device = _device_of(per_la)
    # host copies BEFORE the fork: the workers touch no device tensor
    per_la = [(to_host(o, np.int64), to_host(ln, np.int64),
               to_host(d, np.uint8)) for o, ln, d in per_la]
    stripe_count, cb = plan.n_aggregators, plan.cb
    stripe_size = plan.layout.stripe_size
    n_rounds = plan.n_rounds
    codec = get_codec(plan.slow_hop_codec) if plan.slow_hop_codec else None
    if faults is not None and (
            faults.slow_nodes or faults.lost or faults.delayed
            or faults.torn_window is not None
            or faults.resize_at_write is not None):
        raise ValueError(
            "mp transport: time is wall-clock here, so modeled-timing "
            "faults (slow_nodes/lost/delayed/torn_window/resize) are "
            "not supported — only dead_aggregator (worker kill)")
    if sender_nodes is None:
        sender_nodes = [0] * len(per_la)
    if n_nodes is None:
        n_nodes = int(max(sender_nodes, default=0)) + 1
    serve, serve_nodes = _serve_of(plan, serve_map, stripe_count, n_nodes)
    combined = plan.method == "tam"
    kill = None
    if faults is not None and faults.dead_aggregator is not None:
        kill = (int(faults.dead_aggregator[0]),
                max(0, min(int(faults.dead_aggregator[1]), n_rounds - 1)))
        if not 0 <= kill[0] < len(per_la):
            raise ValueError(f"worker-kill victim {kill[0]} out of range")

    # ---- parent-side schedule (workers inherit it through fork) ------
    sched = {}
    node_bytes = np.zeros((stripe_count, n_nodes), np.int64)
    ga_msgs = np.zeros((stripe_count, n_rounds), np.int64)
    ga_msgs_fast = np.zeros((stripe_count, n_rounds), np.int64)
    combined_seen: set = set()
    senders = []
    for s, (offs, lens, packed) in enumerate(per_la):
        if offs.size == 0:
            continue
        senders.append(s)
        sched[s] = _sender_schedule(offs, lens, packed, stripe_size,
                                    stripe_count, cb)
        for g, po, pl, _, rounds in sched[s]:
            node_bytes[g, sender_nodes[s]] += int(pl.sum())
            fast = serve_nodes[g] == sender_nodes[s]
            for r in rounds:
                if fast:
                    ga_msgs_fast[g, r] += 1
                elif combined:
                    key = (sender_nodes[s], g, r)
                    if key not in combined_seen:
                        combined_seen.add(key)
                        ga_msgs[g, r] += 1
                else:
                    ga_msgs[g, r] += 1
    node_members = {nd: [s for s in senders if sender_nodes[s] == nd]
                    for nd in set(sender_nodes[s] for s in senders)}
    leaders = {nd: min(mem) for nd, mem in node_members.items()}

    # ---- per-node arenas: a region per sender, blocks packed
    # sequentially (payload for fast blocks; pair metadata + encoded
    # payload for TAM slow blocks awaiting the leader's combine) -------
    region_of = {}
    arena_size = {nd: 0 for nd in node_members}
    for s in senders:
        need = 0
        for _, po, pl, _, rounds in sched[s]:
            for _, payload in rounds.values():
                need += int(payload.size) * 2 + 16 * int(po.size) + 128
        nd = sender_nodes[s]
        region_of[s] = arena_size[nd]
        arena_size[nd] += need
    ctx = _ctx()
    shms = {nd: shared_memory.SharedMemory(
        create=True, size=max(sz, 1)) for nd, sz in arena_size.items()}
    arenas = {nd: np.frombuffer(shm.buf, np.uint8)
              for nd, shm in shms.items()}

    # ---- slow-hop listeners: one per destination node ----------------
    listeners = {}
    ports = {}
    for nd in range(n_nodes):
        lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lst.bind(("127.0.0.1", 0))
        lst.listen(len(per_la) + 1)
        lst.settimeout(0.2)
        listeners[nd] = lst
        ports[nd] = lst.getsockname()[1]

    ctrl = ctx.Queue()
    node_qs = {nd: ctx.Queue() for nd in node_members} if combined else {}
    stop = threading.Event()
    lock = threading.Lock()
    slow_blocks: dict = {}     # (s, g, r) -> (po, pl, wire, raw_len)
    arrival: dict = {}
    wire_slow = [0]
    recv_errors: list = []

    def _note(r, now):
        if arrival.get(r, 0.0) < now:
            arrival[r] = now

    def _store(kind, s, g, r, po, pl, wire, raw_len):
        with lock:
            slow_blocks[(s, g, r)] = (po, pl, wire, raw_len)
            _note(r, time.perf_counter())

    def _handle_conn(conn):
        try:
            with conn:
                conn.settimeout(WAIT_S)
                while True:
                    body = tx.recv_msg(conn)
                    if body is None:
                        return
                    with lock:
                        wire_slow[0] += 4 + len(body)
                    kind, sender, g, r, n_req, raw_len, enc_len = \
                        tx.HDR.unpack_from(body, 0)
                    if kind == tx.KIND_BLOCK:
                        _, sender, g, r, po, pl, wire, raw_len = \
                            tx.unpack_block(body)
                        _store(kind, sender, g, r, po, pl, wire, raw_len)
                    elif kind == tx.KIND_COMBINED:
                        pos = tx.HDR.size
                        for _ in range(n_req):   # n_req = subrecords
                            s2, nr, rl, el = tx.SUB.unpack_from(body, pos)
                            pos += tx.SUB.size
                            po, pl = tx.unpack_pairs(
                                body[pos:pos + 16 * nr], nr)
                            pos += 16 * nr
                            _store(kind, s2, g, r, po, pl,
                                   body[pos:pos + el], rl)
                            pos += el
                    else:
                        raise ConnectionError(
                            f"unexpected frame kind {kind}")
        except (OSError, ConnectionError) as e:
            if not stop.is_set():
                recv_errors.append(e)

    def _accept_loop(lst):
        # stop only at a timeout once every worker has exited: a
        # connection still queued in the backlog then holds frames too
        handlers = []
        while True:
            try:
                conn, _ = lst.accept()
            except socket.timeout:
                if stop.is_set():
                    break
                continue
            except OSError:
                break
            th = threading.Thread(target=_handle_conn, args=(conn,))
            th.start()
            handlers.append(th)
        for th in handlers:
            th.join(WAIT_S)

    acceptors = [threading.Thread(target=_accept_loop, args=(lst,))
                 for lst in listeners.values()]
    for th in acceptors:
        th.start()

    # ---- the worker (forked: closes over everything above) -----------
    def _worker(s):
        my_node = sender_nodes[s]
        arena = arenas[my_node]
        pos = region_of[s]
        conns: dict = {}

        def _conn(d):
            if d not in conns:
                sk = socket.create_connection(("127.0.0.1", ports[d]),
                                              timeout=WAIT_S)
                sk.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conns[d] = sk
            return conns[d]

        try:
            for g, po, pl, _, rounds in sched[s]:
                fast = serve_nodes[g] == my_node
                for r in sorted(rounds):
                    if kill is not None and s == kill[0] and r >= kill[1]:
                        os._exit(_KILL_EXIT)
                    in_r, payload = rounds[r]
                    if fast:
                        # fast hop: raw bytes into the arena, descriptor
                        # through the control queue — parent reads the
                        # same mapping zero-copy
                        n = int(payload.size)
                        arena[pos:pos + n] = payload
                        ctrl.put(("fast", s, g, r, pos, n))
                        pos += n
                    else:
                        wire = (np.asarray(codec.encode_bytes(payload),
                                           np.uint8)
                                if codec is not None else payload)
                        if combined:
                            # stage for the node leader's combine
                            meta = np.frombuffer(
                                tx.pack_pairs(po[in_r], pl[in_r]),
                                np.uint8)
                            arena[pos:pos + meta.size] = meta
                            mpos = pos
                            pos += meta.size
                            arena[pos:pos + wire.size] = wire
                            node_qs[my_node].put(
                                ("blk", s, g, r, mpos, int(in_r.sum()),
                                 pos, int(wire.size), int(payload.size)))
                            pos += int(wire.size)
                        else:
                            body = tx.pack_block(
                                tx.KIND_BLOCK, s, g, r, po[in_r],
                                pl[in_r], wire.tobytes(),
                                int(payload.size))
                            tx.send_msg(_conn(serve_nodes[g]), body)
            if combined:
                node_qs[my_node].put(("done", s))
                if s == leaders[my_node]:
                    _leader_combine(s, my_node, conns)
            ctrl.put(("done", s))
        finally:
            for sk in conns.values():
                try:
                    sk.close()
                except OSError:
                    pass

    def _leader_combine(me, my_node, conns):
        """TAM: gather co-located slow blocks from the arena, send one
        combined frame per (domain, round)."""
        arena = arenas[my_node]
        waiting = set(node_members[my_node])
        blocks: dict = {}
        while waiting:
            msg = node_qs[my_node].get(timeout=WAIT_S)
            if msg[0] == "done":
                waiting.discard(msg[1])
            else:
                _, s2, g, r, mpos, n_req, wpos, enc_len, raw_len = msg
                blocks.setdefault((g, r), []).append(
                    (s2, n_req, mpos, wpos, enc_len, raw_len))
        for (g, r), subs in sorted(blocks.items()):
            subs.sort()
            parts = [tx.HDR.pack(tx.KIND_COMBINED, me, g, r, len(subs),
                                 sum(x[5] for x in subs),
                                 sum(x[4] for x in subs))]
            for s2, n_req, mpos, wpos, enc_len, raw_len in subs:
                parts.append(tx.SUB.pack(s2, n_req, raw_len, enc_len))
                parts.append(arena[mpos:mpos + 16 * n_req].tobytes())
                parts.append(arena[wpos:wpos + enc_len].tobytes())
            d = serve_nodes[g]
            if d not in conns:
                sk = socket.create_connection(("127.0.0.1", ports[d]),
                                              timeout=WAIT_S)
                sk.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conns[d] = sk
            tx.send_msg(conns[d], b"".join(parts))

    fast_blocks: dict = {}
    dead: dict = {}
    procs = {}
    t0 = time.perf_counter()
    try:
        for s in senders:
            p = ctx.Process(target=_worker, args=(s,), daemon=True)
            p.start()
            procs[s] = p

        # ---- drain the control queue until every worker reported ----
        pending = set(senders)
        deadline = time.monotonic() + WAIT_S
        while pending:
            try:
                msg = ctrl.get(timeout=0.05)
            except queue_mod.Empty:
                for s in list(pending):
                    p = procs[s]
                    if not p.is_alive() and p.exitcode not in (0, None):
                        p.join()
                        dead[s] = p.exitcode
                        pending.discard(s)
                        if combined:
                            # unblock the leader's member wait
                            node_qs[sender_nodes[s]].put(("done", s))
                if time.monotonic() > deadline:
                    raise _Failed(
                        f"mp transport: workers hung: {sorted(pending)}")
                continue
            if msg[0] == "done":
                pending.discard(msg[1])
            else:
                _, s, g, r, off, nbytes = msg
                fast_blocks[(s, g, r)] = (off, nbytes)
                _note(r, time.perf_counter())
        for s, p in procs.items():
            p.join(WAIT_S)
            if p.is_alive():
                raise _Failed(f"mp transport: worker {s} did not exit")
        comm_wall = time.perf_counter() - t0
        stop.set()
        for th in acceptors:           # each drains its backlog first
            th.join(WAIT_S)
        for lst in listeners.values():
            lst.close()
        if recv_errors:
            raise _Failed(f"mp transport: receive failed: {recv_errors}")

        # ---- death audit + repair -----------------------------------
        unexpected = {s: code for s, code in dead.items()
                      if kill is None or s != kill[0]
                      or code != _KILL_EXIT}
        if unexpected:
            raise _Failed(
                f"mp transport: workers died: {unexpected}")
        repaired: set = set()
        if dead:
            t_rec = time.perf_counter()
            victim = next(iter(dead))
            victim_node = sender_nodes[victim]
            if heartbeat is not None:
                heartbeat.inject_failure(victim_node)
                assert victim_node in heartbeat.dead_hosts()
                detect_s = float(heartbeat.timeout_s)
            else:
                detect_s = float(faults.detection_s)
            # blocks whose responsible process died: the victim's own,
            # plus (TAM) everything its node's leader never combined
            for (s, g, r) in _expected_blocks(sched, senders):
                have = (s, g, r) in fast_blocks \
                    or (s, g, r) in slow_blocks
                if have:
                    continue
                leader_dead = combined and \
                    leaders[sender_nodes[s]] in dead
                if s not in dead and not leader_dead:
                    raise _Failed(f"mp transport: block ({s},{g},{r}) "
                                  "missing from a live worker")
                repaired.add((s, g, r))
            t.recovery_seconds += detect_s \
                + (time.perf_counter() - t_rec)
        else:
            missing = [k for k in _expected_blocks(sched, senders)
                       if k not in fast_blocks and k not in slow_blocks]
            if missing:
                raise _Failed(f"mp transport: blocks missing with all "
                              f"workers healthy: {missing[:4]}")

        # ---- reassemble the per-domain inboxes (host sender order) --
        ga_inbox: list[list] = [[] for _ in range(stripe_count)]
        raw_total = wire_total = fast_bytes = 0
        dec_wall = 0.0
        for s in senders:
            for g, po, pl, seg_starts, rounds in sched[s]:
                pd = np.zeros(int(pl.sum()), np.uint8)
                for r in sorted(rounds):
                    in_r, payload = rounds[r]
                    if (s, g, r) in fast_blocks:
                        off, nbytes = fast_blocks[(s, g, r)]
                        src = arenas[sender_nodes[s]][off:off + nbytes]
                        fast_bytes += nbytes
                    elif (s, g, r) in slow_blocks:
                        rpo, rpl, wire, raw_len = slow_blocks[(s, g, r)]
                        if not (np.array_equal(rpo, po[in_r])
                                and np.array_equal(rpl, pl[in_r])):
                            raise _Failed(
                                f"mp transport: pair metadata mismatch "
                                f"for block ({s},{g},{r})")
                        wire_arr = np.frombuffer(wire, np.uint8)
                        if codec is not None:
                            d0 = time.perf_counter()
                            src = np.asarray(
                                codec.decode_bytes(wire_arr), np.uint8)
                            dec_wall += time.perf_counter() - d0
                            raw_total += int(raw_len)
                            wire_total += int(wire_arr.size)
                        else:
                            src = wire_arr
                        if src.size != raw_len:
                            raise _Failed(
                                f"mp transport: block ({s},{g},{r}) "
                                f"decoded to {src.size} != {raw_len}")
                    else:        # repaired from the parent's stage-1 copy
                        assert (s, g, r) in repaired
                        src = payload
                    pos = 0
                    for st, ln in zip(seg_starts[in_r], pl[in_r]):
                        pd[st:st + ln] = src[pos:pos + ln]
                        pos += ln
                ga_inbox[g].append((po, pl, pd))

        # ---- measured timings ---------------------------------------
        t.transport = "mp"
        t.rounds_executed = n_rounds
        comm_rounds = _round_walls(arrival, n_rounds, t0)
        if not arrival:           # everything landed before first stamp
            comm_rounds[-1:] = [comm_wall] if n_rounds else []
        t.comm_rounds = tuple(comm_rounds)
        t.inter_comm = float(sum(comm_rounds))
        t.messages_at_ga = int((ga_msgs + ga_msgs_fast).max(initial=0))
        t.placement = plan.placement
        t.slow_hop_fast_bytes = int(fast_bytes)
        t.slow_hop_slow_bytes = int(wire_slow[0])
        t.node_bytes = tuple(tuple(int(b) for b in row)
                             for row in node_bytes)
        if codec is not None:
            t.slow_hop_codec = codec.name
            t.slow_hop_raw_bytes = int(raw_total)
            t.slow_hop_wire_bytes = int(wire_total)
            t.codec = float(dec_wall)
        t.serve_map = serve if serve_map is not None else None
        t.retries = 0

        # ---- sort + drain (the host oracle's exact byte path) -------
        depth = plan.pipeline_depth
        multi_window = n_rounds > 1
        segs, img_lens = _drain(plan, m, t, ga_inbox, device)
        io_wall = np.zeros(stripe_count)
        for g in range(stripe_count):
            cbw = cb if multi_window and depth > 1 else None
            w0 = time.perf_counter()
            write_segment(f"{path}.seg{g}", segs[g], cbw, depth=depth)
            io_wall[g] = time.perf_counter() - w0
        # split each segment's measured drain wall across its windows
        # by byte share, for the session's per-round feedback arrays
        lo = np.arange(n_rounds, dtype=np.int64) * cb
        share = np.clip(img_lens[:, None] - lo[None, :], 0, cb) \
            .astype(np.float64)
        tot = share.sum(axis=1, keepdims=True)
        share = np.divide(share, np.where(tot == 0, 1, tot))
        io_rounds = (share * io_wall[:, None]).sum(axis=0)
        t.io = float(io_wall.sum())
        t.io_rounds = tuple(float(x) for x in io_rounds)
        if depth_request == "auto" and multi_window:
            depth, _ = optimal_depth(
                round_times=(np.asarray(comm_rounds), io_rounds))
        t.pipeline_depth = max(1, min(depth, n_rounds))
        return t
    finally:
        stop.set()
        for lst in listeners.values():
            try:
                lst.close()
            except OSError:
                pass
        for p in procs.values():
            if p.is_alive():
                p.terminate()
                p.join(1.0)
        # drop every parent-side view of the arenas so close() can
        # release the exported buffer (otherwise __del__ whines)
        src = None
        arenas.clear()
        for shm in shms.values():
            try:
                shm.close()
            except BufferError:
                pass       # a view survived anyway; unlink suffices
            try:
                shm.unlink()
            except (OSError, FileNotFoundError):
                pass


def _device_of(per_la):
    return next((o.device for o, _, _ in per_la
                 if isinstance(o, torch.Tensor)), torch.device("cpu"))


def _drain(plan, machine, t, ga_inbox, device):
    """The reassembled per-domain inboxes (numpy, sender order)
    through the host executor's drain on ``device``."""
    parts = [(po, pl, pd, g) for g in range(len(ga_inbox))
             for po, pl, pd in ga_inbox[g]]
    cat = lambda i, dt: torch.from_numpy(np.concatenate(  # noqa: E731
        [p[i] for p in parts] + [np.zeros(0, dt)])).to(device)
    owner = torch.from_numpy(np.repeat(
        np.asarray([p[3] for p in parts], np.int64),
        [p[0].size for p in parts])).to(device)
    return drain_images(plan, machine, t, cat(0, np.int64),
                        cat(1, np.int64), cat(2, np.uint8), owner,
                        [len(box) for box in ga_inbox])


def _expected_blocks(sched, senders):
    for s in senders:
        for g, _, _, _, rounds in sched[s]:
            for r in rounds:
                yield (s, g, r)


def execute_read(plan, machine, rank_requests, path, t, *, n_nodes,
                 ranks_per_node, depth_request=None, node_cache=True,
                 serve_map=None, faults=None, device=None):
    """Run a read plan on real reader processes (the write's mirror).

    Same signature and byte contract as
    :func:`repro_torch.checkpoint.host_exec.execute_read` (the per-rank
    payloads come back as uint8 tensors on ``device``). The parent does
    the ranged window reads (it owns the segment files), ships each
    needed window ONCE per (window, node) to that node's elected
    fetcher over a socket (``node_cache=True``; codec-encoded when the
    node is off the serving slot's node), the fetcher stages it in the
    node arena and fans it out to co-located readers through their
    queues, and each reader assembles its spans into a result arena.
    ``node_cache=False`` ships every window to every needing rank.
    """
    m = machine
    stripe_count, cb = plan.n_aggregators, plan.cb
    stripe_size = plan.layout.stripe_size
    n_rounds = plan.n_rounds
    codec = get_codec(plan.slow_hop_codec) if plan.slow_hop_codec else None
    if faults is not None:
        raise ValueError("mp transport: fault injection is write-side "
                         "only (worker kill); reads take faults=None")
    serve, serve_nodes = _serve_of(plan, serve_map, stripe_count, n_nodes)
    if device is None:
        device = next((o.device for o, _ in rank_requests
                       if isinstance(o, torch.Tensor)), torch.device("cpu"))
    # host copies BEFORE the fork: the readers touch no device tensor
    rank_requests = [(to_host(o, np.int64), to_host(ln, np.int64))
                     for o, ln in rank_requests]

    # ---- demand map (host_exec.execute_read, verbatim semantics) -----
    win_need: dict = {}
    win_spans: dict = {}
    rank_spans = []
    node_bytes = np.zeros((stripe_count, n_nodes), np.int64)
    for rank, (offs, lens) in enumerate(rank_requests):
        nd = rank // ranks_per_node
        spans = []
        out_pos = 0
        for o, ln in zip(np.asarray(offs, np.int64),
                         np.asarray(lens, np.int64)):
            g = int((o // stripe_size) % stripe_count)
            dl = int(to_domain_local(o, stripe_size, stripe_count))
            node_bytes[g, nd] += int(ln)
            pos = 0
            while pos < ln:
                r = (dl + pos) // cb
                take = int(min(ln - pos, (r + 1) * cb - (dl + pos)))
                wo = int(dl + pos - r * cb)
                spans.append((g, int(r), wo, take, out_pos + pos))
                win_spans.setdefault((g, int(r)), []).append((wo, take))
                per_rank = (win_need.setdefault((g, int(r)), {})
                            .setdefault(nd, {}))
                per_rank[rank] = per_rank.get(rank, 0) + take
                pos += take
            out_pos += int(ln)
        rank_spans.append((spans, out_pos))

    # ---- ranged reads: the parent owns the disk ----------------------
    needed_gs = sorted({g for g, _ in win_need})
    for g in needed_gs:
        if os.path.exists(partial_marker(f"{path}.seg{g}")):
            raise TornWriteError(f"{path}.seg{g}", -1, -1)
    seg_len = {g: (os.path.getsize(f"{path}.seg{g}")
                   if os.path.exists(f"{path}.seg{g}") else 0)
               for g in needed_gs}
    windows: dict = {}
    io_arrival: dict = {}
    t_io0 = time.perf_counter()
    handles = {g: (open(f"{path}.seg{g}", "rb") if seg_len[g] else None)
               for g in needed_gs}
    try:
        for (g, r) in sorted(win_need):
            base = r * cb
            buf = np.zeros(cb, np.uint8)
            runs = []
            for wo, take in sorted(win_spans[(g, r)]):
                if runs and wo <= runs[-1][1]:
                    runs[-1][1] = max(runs[-1][1], wo + take)
                else:
                    runs.append([wo, wo + take])
            for lo_, hi in runs:
                hi_f = min(base + hi, seg_len[g])
                take = hi_f - (base + lo_)
                if take > 0:
                    handles[g].seek(base + lo_)
                    buf[lo_:lo_ + take] = np.frombuffer(
                        handles[g].read(take), np.uint8)
                    t.read_bytes += int(take)
            windows[(g, r)] = buf
            io_arrival[r] = time.perf_counter()
    finally:
        for f in handles.values():
            if f is not None:
                f.close()
    io_rounds = _round_walls(io_arrival, n_rounds, t_io0)

    # ---- codec: encode once at the serving side; every consumer sees
    # the round-tripped window (host oracle identity) ------------------
    enc_wire: dict = {}
    raw_total = wire_total = 0
    for (g, r), per_node in sorted(win_need.items()):
        if codec is not None and any(serve_nodes[g] != nd
                                     for nd in per_node):
            wire = np.asarray(codec.encode_bytes(windows[(g, r)]),
                              np.uint8)
            windows[(g, r)] = np.asarray(
                codec.decode_bytes(wire), np.uint8)
            enc_wire[(g, r)] = wire
            raw_total += int(windows[(g, r)].size)
            wire_total += int(wire.size)

    # ---- fetch plan: one elected fetcher per (window, node) ----------
    fetch_of: dict = {}
    readers_of: dict = {}
    stage_bytes = np.zeros(n_nodes, np.int64)
    for (g, r), per_node in sorted(win_need.items()):
        for nd, readers in sorted(per_node.items()):
            readers_of[(g, r, nd)] = sorted(readers)
            if node_cache:
                fetch_of[(g, r, nd)] = min(readers)
                t.cache_misses += 1
                t.cache_hits += len(readers) - 1
                stage_bytes[nd] += cb
            else:
                t.cache_misses += len(readers)
    slot_of: dict = {}
    slots_per_node = {nd: 0 for nd in range(n_nodes)}
    if node_cache:
        for (g, r, nd) in sorted(fetch_of):
            slot_of[(g, r, nd)] = slots_per_node[nd]
            slots_per_node[nd] += 1

    worker_ranks = [rank for rank, (spans, total) in
                    enumerate(rank_spans) if spans]
    needed: dict = {}
    spans_by_win: dict = {}
    for rank in worker_ranks:
        spans, _ = rank_spans[rank]
        wins = sorted({(g, r) for g, r, _, _, _ in spans})
        needed[rank] = wins
        for g, r, wo, ln, op in spans:
            spans_by_win.setdefault((rank, g, r), []).append(
                (wo, ln, op))

    # frames each rank receives over its socket, in global window order
    to_rank: dict = {rank: [] for rank in worker_ranks}
    for (g, r) in sorted(win_need):
        for nd in sorted(win_need[(g, r)]):
            if node_cache:
                to_rank[fetch_of[(g, r, nd)]].append((g, r, nd))
            else:
                for rank in readers_of[(g, r, nd)]:
                    to_rank[rank].append((g, r, nd))

    ctx = _ctx()
    res_off = {}
    res_total = 0
    for rank, (spans, total) in enumerate(rank_spans):
        res_off[rank] = res_total
        res_total += total
    res_shm = shared_memory.SharedMemory(create=True,
                                         size=max(res_total, 1))
    res_arena = np.frombuffer(res_shm.buf, np.uint8)
    cache_shms = {nd: shared_memory.SharedMemory(
        create=True, size=max(slots_per_node.get(nd, 0) * cb, 1))
        for nd in range(n_nodes)} if node_cache else {}
    cache_arenas = {nd: np.frombuffer(shm.buf, np.uint8)
                    for nd, shm in cache_shms.items()}
    rank_qs = {rank: ctx.Queue() for rank in worker_ranks}
    ctrl = ctx.Queue()

    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lst.bind(("127.0.0.1", 0))
    lst.listen(len(worker_ranks) + 1)
    lst.settimeout(WAIT_S)
    port = lst.getsockname()[1]

    def _reader(rank):
        nd = rank // ranks_per_node
        sk = socket.create_connection(("127.0.0.1", port),
                                      timeout=WAIT_S)
        try:
            sk.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sk.settimeout(WAIT_S)
            sk.sendall(struct.pack("!I", rank))
            _, total = rank_spans[rank]
            buf = np.zeros(total, np.uint8)
            stash: set = set()
            for (g, r) in needed[rank]:
                mine = (not node_cache) or fetch_of[(g, r, nd)] == rank
                if mine:
                    body = tx.recv_msg(sk)
                    kind, _, g2, r2, _, _, wire, _ = \
                        tx.unpack_block(body)
                    if (g2, r2) != (g, r):
                        raise ConnectionError(
                            f"rank {rank}: window ({g2},{r2}) arrived, "
                            f"({g},{r}) expected")
                    warr = np.frombuffer(wire, np.uint8)
                    win = (np.asarray(codec.decode_bytes(warr), np.uint8)
                           if kind & tx.FLAG_ENCODED else warr)
                    if node_cache:
                        slot = slot_of[(g, r, nd)]
                        cache_arenas[nd][slot * cb:slot * cb + cb] = win
                        for rk in readers_of[(g, r, nd)]:
                            if rk != rank:
                                rank_qs[rk].put((g, r))
                        src = cache_arenas[nd][slot * cb:slot * cb + cb]
                    else:
                        src = win
                else:
                    while (g, r) not in stash:
                        stash.add(rank_qs[rank].get(timeout=WAIT_S))
                    slot = slot_of[(g, r, nd)]
                    src = cache_arenas[nd][slot * cb:slot * cb + cb]
                for wo, ln, op in spans_by_win[(rank, g, r)]:
                    buf[op:op + ln] = src[wo:wo + ln]
            off = res_off[rank]
            res_arena[off:off + total] = buf
            ctrl.put(("done", rank))
        finally:
            sk.close()

    conns: dict = {}
    send_errors: list = []
    arrival: dict = {}
    wire_slow = [0]
    wire_fast = [0]
    lock = threading.Lock()

    def _send_to(rank, conn):
        try:
            conn.settimeout(WAIT_S)
            for (g, r, nd) in to_rank[rank]:
                enc = (g, r) in enc_wire and nd != serve_nodes[g]
                payload = (enc_wire[(g, r)] if enc
                           else windows[(g, r)])
                kind = tx.KIND_WINDOW | (tx.FLAG_ENCODED if enc else 0)
                body = tx.pack_block(
                    kind, rank, g, r, np.zeros(0, np.int64),
                    np.zeros(0, np.int64), payload.tobytes(), cb)
                n = tx.send_msg(conn, body)
                with lock:
                    (wire_slow if nd != serve_nodes[g]
                     else wire_fast)[0] += n
                    if arrival.get(r, 0.0) < time.perf_counter():
                        arrival[r] = time.perf_counter()
        except (OSError, ConnectionError) as e:
            send_errors.append((rank, e))

    procs = {}
    t0 = time.perf_counter()
    try:
        for rank in worker_ranks:
            p = ctx.Process(target=_reader, args=(rank,), daemon=True)
            p.start()
            procs[rank] = p
        senders_th = []
        for _ in worker_ranks:
            conn, _ = lst.accept()
            (rank,) = struct.unpack("!I", tx.recv_exact(conn, 4))
            conns[rank] = conn
            th = threading.Thread(target=_send_to, args=(rank, conn))
            th.start()
            senders_th.append(th)
        for th in senders_th:
            th.join(WAIT_S)
        pending = set(worker_ranks)
        deadline = time.monotonic() + WAIT_S
        while pending:
            try:
                msg = ctrl.get(timeout=0.05)
            except queue_mod.Empty:
                for rank in list(pending):
                    p = procs[rank]
                    if not p.is_alive() and p.exitcode not in (0, None):
                        raise _Failed(f"mp transport: reader {rank} "
                                      f"died (exit {p.exitcode})")
                if time.monotonic() > deadline:
                    raise _Failed(
                        f"mp transport: readers hung: {sorted(pending)}")
                continue
            pending.discard(msg[1])
        for p in procs.values():
            p.join(WAIT_S)
        if send_errors:
            raise _Failed(f"mp transport: window send failed: "
                          f"{send_errors}")
        if arrival:
            arrival[max(arrival)] = max(arrival[max(arrival)],
                                        time.perf_counter())

        outs = []
        for rank, (spans, total) in enumerate(rank_spans):
            off = res_off[rank]
            outs.append(torch.from_numpy(
                np.array(res_arena[off:off + total])).to(device))

        # ---- measured + counted timings -----------------------------
        t.transport = "mp"
        t.rounds_executed = n_rounds
        comm_rounds = _round_walls(arrival, n_rounds, t0)
        t.comm_rounds = tuple(comm_rounds)
        t.inter_comm = float(sum(comm_rounds))
        t.io_rounds = tuple(io_rounds)
        t.io = float(sum(io_rounds))
        ga_msgs = np.zeros((stripe_count, n_rounds), np.int64)
        ga_msgs_fast = np.zeros((stripe_count, n_rounds), np.int64)
        for (g, r), per_node in win_need.items():
            for nd, readers in per_node.items():
                n_f = 1 if node_cache else len(readers)
                if nd == serve_nodes[g]:
                    ga_msgs_fast[g, r] += n_f
                else:
                    ga_msgs[g, r] += n_f
        t.messages_at_ga = int((ga_msgs + ga_msgs_fast).max(initial=0))
        t.placement = plan.placement
        t.slow_hop_slow_bytes = int(wire_slow[0])
        t.slow_hop_fast_bytes = int(wire_fast[0])
        t.node_bytes = tuple(tuple(int(b) for b in row)
                             for row in node_bytes)
        t.intra_memcpy = float(stage_bytes.max(initial=0)) / m.memcpy_bw
        if codec is not None:
            t.slow_hop_codec = codec.name
            t.slow_hop_raw_bytes = int(raw_total)
            t.slow_hop_wire_bytes = int(wire_total)
        t.serve_map = serve if serve_map is not None else None
        depth = plan.pipeline_depth
        if depth_request == "auto" and n_rounds > 1:
            depth, _ = optimal_depth(round_times=(
                np.asarray(comm_rounds), np.asarray(io_rounds)))
        t.pipeline_depth = max(1, min(depth, n_rounds))
        return outs
    finally:
        try:
            lst.close()
        except OSError:
            pass
        for conn in conns.values():
            try:
                conn.close()
            except OSError:
                pass
        for p in procs.values():
            if p.is_alive():
                p.terminate()
                p.join(1.0)
        # drop every parent-side view so close() can release the buffer
        res_arena = None
        cache_arenas.clear()
        for shm in list(cache_shms.values()) + [res_shm]:
            try:
                shm.close()
            except BufferError:
                pass       # a view survived anyway; unlink suffices
            try:
                shm.unlink()
            except (OSError, FileNotFoundError):
                pass
