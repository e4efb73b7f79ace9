"""Host executor: runs a compiled :class:`repro_torch.core.plan.IOPlan`
with real data movement and modeled alpha-beta timing (port of
``repro.checkpoint.host_exec``).

One of the interchangeable backends of the plan/executor split; the
others are the rank-axis executor (``repro_torch.core.spmd_exec``) and
the multi-process transport (``checkpoint.mp_exec``). The plan comes
from the SAME planner (``HostCollectiveIO.plan_for`` routes through
``compile_plan`` in byte units), so the window schedule the host drains
is the one the rank-axis ring would run.

What is real vs modeled: bytes are REAL — requests are merged,
coalesced and packed as tensors on the executor's device (the device of
the requests it is given), each aggregator's domain image is built one
cb window at a time by the ``pack`` kernel (``kernels.ops.pack``; its
plain version on a CPU tensor), and every segment file on disk is
byte-identical whatever the schedule (single shot, rounds, any ring
depth). TIME is modeled — the per-round incast latency
``alpha_eff(senders)``, the beta byte costs and the depth-k pipeline
makespan (``cost_model.pipeline_span`` over the measured per-round
comm/drain arrays), in Python floats and numpy float64 in the
reference's order of operations, so the modeled ``IOTimings`` equal the
reference's. Message counts and byte sums are integers, counted on the
device and reduced on the host. The drain is physical too: with a
multi-round plan each segment is written through a background writer
thread fed one cb window of host bytes at a time through a ring of
``depth - 1`` queue slots.
"""
from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

from repro_torch.core import placement as placement_mod
from repro_torch.core._tensor import (cat_views, exclusive_cumsum,
                                      gather_spans, scatter_spans,
                                      to_host)
from repro_torch.core.codec import get_codec
from repro_torch.core.cost_model import optimal_depth, pipeline_span
from repro_torch.core.faults import (TornWriteError, UnrecoverableFaultError,
                                     measure_node_slowdown, partial_marker,
                                     repair_map)
from repro_torch.core.requests import RequestList
from repro_torch.kernels import ops

PAIR_BYTES = 8  # offset + length metadata per request
#: the longest piece of a domain image one ``pack`` call builds when the
#: plan's window is longer (a single-shot segment)
MAX_PACK_WINDOW = 1 << 30
#: request slots one ``pack`` call takes (``kernels/pack.py``)
MAX_PACK_REQUESTS = 32768


def to_domain_local(offs, stripe_size: int, stripe_count: int):
    """Byte position inside the owning GA's domain image (its stripes
    concatenated in round order) — mirrors ``domains.to_domain_local``.
    Takes numpy arrays, tensors or ints."""
    return ((offs // stripe_size) // stripe_count) * stripe_size \
        + offs % stripe_size


def flatten(reqs):
    """Per-sender ``(offsets, lengths, payload)`` tensors as one request
    stream in sender order: ``(offsets, lengths, sender, payload)``, the
    payload packed in request order."""
    dev = reqs[0][0].device if reqs else torch.device("cpu")
    counts = torch.tensor([int(r[0].numel()) for r in reqs],
                          dtype=torch.int64)
    if not reqs or int(counts.sum()) == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return (empty, empty, empty,
                torch.zeros(0, dtype=torch.uint8, device=dev))
    offs = torch.cat([r[0].to(torch.int64) for r in reqs])
    lens = torch.cat([r[1].to(torch.int64) for r in reqs])
    sender = torch.repeat_interleave(
        torch.arange(len(reqs), device=dev), counts.to(dev))
    # a payload past its requests' bytes is not sent (the reference's
    # starts come from the lengths alone)
    used = torch.zeros(len(reqs), dtype=torch.int64, device=dev) \
        .index_add_(0, sender, lens).tolist()
    data = cat_views([r[2][:n] for r, n in zip(reqs, used)], dev)
    return offs, lens, sender, data


def merge_coalesce_groups(offs, lens, data, group, n_groups: int):
    """Merge, sort and coalesce the requests of every group at once.

    ``offs``/``lens`` (int64) and ``group`` are ``[N]`` with ``data``
    packed in request order; within a group the input order is the
    order the reference concatenates its senders in. Each group's
    requests are stably sorted by byte offset, their payload gathered
    in that order, and exactly contiguous neighbours
    (``offset[i] + length[i] == offset[i+1]``) coalesced, in int64.
    Returns ``(offsets, lengths, packed, group)`` of the coalesced
    requests (group-major) and the int64 requests per group before
    coalescing, ``[n_groups]`` on the host.
    """
    n_req = torch.bincount(group, minlength=n_groups).cpu().numpy()
    if offs.numel() == 0:
        return offs, lens, data[:0], group, n_req
    order = torch.sort(offs, stable=True).indices
    order = order[torch.sort(group[order], stable=True).indices]
    s_off, s_len, s_grp = offs[order], lens[order], group[order]
    packed = gather_spans(data, exclusive_cumsum(lens)[order], s_len)
    boundary = torch.ones_like(s_off, dtype=torch.bool)
    boundary[1:] = ((s_off[1:] != s_off[:-1] + s_len[:-1])
                    | (s_grp[1:] != s_grp[:-1]))
    run = torch.cumsum(boundary.to(torch.int64), 0) - 1
    n_run = int(run[-1].item()) + 1
    out_len = torch.zeros(n_run, dtype=torch.int64,
                          device=offs.device).index_add_(0, run, s_len)
    return s_off[boundary], out_len, packed, s_grp[boundary], n_req


def n_comparisons(n_requests: int, n_senders: int) -> int:
    """The sort-time model's comparison count of one merge of
    ``n_senders`` lists holding ``n_requests`` requests."""
    if n_requests == 0:
        return 0
    return int(n_requests * max(np.log2(max(n_senders, 2)), 1))


def merge_coalesce(reqs):
    """Merge per-sender ``(offsets, lengths, payload)`` tensors, sort,
    coalesce.

    Returns ``(offsets, lengths, payload, n_cmp)`` with the payload
    packed in sorted offset order (contiguous per coalesced run) and
    the comparisons counted for the sort-time model.
    """
    offs, lens, _, data = flatten(reqs)
    group = torch.zeros_like(offs)
    o, ln, packed, _, n_req = merge_coalesce_groups(offs, lens, data,
                                                    group, 1)
    return o, ln, packed, n_comparisons(int(n_req[0]), len(reqs))


def _range_max(lo, hi, val, n: int):
    """``out[i] = max(val[j] for lo[j] <= i < hi[j])``, -1 where no range
    covers i, over ``n`` cells, for ranges of at least one cell. Each
    range is written as two power-of-two blocks that cover it (a sparse
    table read backwards), and each level's maxima are pushed into the
    two halves below: work ``n log n`` over cells, never per byte."""
    length = hi - lo
    k = torch.floor(torch.log2(length.double())).to(torch.int64)
    k = k - ((1 << k) > length).to(torch.int64)         # log2 of a double
    k = k + ((2 << k) <= length).to(torch.int64)        # may round
    out = None
    for lev in range(int(k.max().item()), -1, -1):
        t = torch.full((n,), -1, dtype=torch.int64, device=val.device)
        sel = k == lev
        t.scatter_reduce_(0, lo[sel], val[sel], "amax")
        t.scatter_reduce_(0, hi[sel] - (1 << lev), val[sel], "amax")
        if out is not None:
            half = 1 << lev
            t = torch.maximum(t, out)
            t[half:] = torch.maximum(t[half:], out[:n - half])
        out = t
    return out


def _last_writer_pieces(local, lens, starts):
    """Sorted, disjoint pieces that give every position the bytes of the
    LAST request (in sorted order) covering it — what the reference's
    request-by-request copy leaves — for a list where a request lies
    nested inside an earlier, longer one (or ends before an earlier
    one's end). Returns ``(local, lens, starts)`` int64 tensors.

    Works on the elementary intervals between the requests' ends (at
    most twice as many as requests), never on bytes: each interval's
    winner is the largest index of a request covering it, and
    neighbouring intervals with one winner merge into a piece."""
    req = torch.nonzero(lens > 0).squeeze(1)
    a, e = local[req], local[req] + lens[req]
    bounds = torch.unique(torch.cat([a, e]))     # sorted
    n = max(bounds.numel() - 1, 0)
    winner = _range_max(torch.searchsorted(bounds, a),
                        torch.searchsorted(bounds, e), req, n) \
        if req.numel() else torch.zeros(0, dtype=torch.int64,
                                        device=lens.device)
    c = torch.nonzero(winner >= 0).squeeze(1)
    s, t, w = bounds[c], bounds[c + 1], winner[c]
    new = torch.ones_like(c, dtype=torch.bool)
    new[1:] = (s[1:] != t[:-1]) | (w[1:] != w[:-1])
    run = torch.cumsum(new.to(torch.int64), 0) - 1
    head = torch.nonzero(new).squeeze(1)
    piece_len = torch.zeros(head.numel(), dtype=torch.int64,
                            device=lens.device).index_add_(0, run, t - s)
    p0, w0 = s[head], w[head]
    return p0, piece_len, starts[w0] + (p0 - local[w0])


def domain_image(offs, lens, packed, g, stripe_size, stripe_count, *,
                 window: int | None = None):
    """Dense image of aggregator g's file domain (its stripes, in round
    order), mirroring ``core.domains.to_domain_local``: every position
    holds the bytes of the last request (in the given offset-sorted
    order) that covers it, 0 where none does.

    Built by the ``pack`` kernel (``kernels.ops.pack``), one call per
    ``window`` bytes of the image (at most :data:`MAX_PACK_WINDOW`) and
    per :data:`MAX_PACK_REQUESTS` requests of a window, with
    window-relative int32 offsets and ``base = 0``. ``pack`` takes the
    last request at or before each position, so a list with a request
    nested inside an earlier, longer one is first resolved into
    disjoint pieces. Offsets and lengths are int64 tensors on the
    device of ``packed`` (uint8, in request order).
    """
    dev = packed.device
    if offs.numel() == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    n_rounds = int(((offs // stripe_size) // stripe_count).max().item()) + 1
    img_len = n_rounds * stripe_size
    img = torch.zeros(img_len, dtype=torch.uint8, device=dev)
    local = to_domain_local(offs, stripe_size, stripe_count)
    starts = exclusive_cumsum(lens)
    ends = local + lens
    if offs.numel() > 1 and bool(
            (ends[1:] < torch.cummax(ends, 0).values[:-1]).any()):
        local, lens, starts = _last_writer_pieces(local, lens, starts)
        ends = local + lens
    win = min(int(window or MAX_PACK_WINDOW), MAX_PACK_WINDOW)
    h_local, h_ends = local.cpu().numpy(), ends.cpu().numpy()
    for lo in range(0, img_len, win):
        hi = min(lo + win, img_len)
        i0 = int(np.searchsorted(h_ends, lo, side="right"))
        i1 = int(np.searchsorted(h_local, hi, side="left"))
        for b0 in range(i0, i1, MAX_PACK_REQUESTS):
            b1 = min(b0 + MAX_PACK_REQUESTS, i1)
            p_lo = local[b0:b1].clamp(min=lo)
            p_len = ends[b0:b1].clamp(max=hi) - p_lo
            p_st = starts[b0:b1] + (p_lo - local[b0:b1])
            out_lo = max(int(h_local[b0]), lo)
            out_hi = min(int(h_ends[b1 - 1]), hi)
            d_lo = int(p_st.min().item())
            d_hi = int((p_st + p_len).max().item())
            r = RequestList((p_lo - out_lo).to(torch.int32),
                            p_len.to(torch.int32),
                            torch.tensor(b1 - b0, dtype=torch.int32))
            img[out_lo:out_hi] = ops.pack(
                r, (p_st - d_lo).to(torch.int32), packed[d_lo:d_hi], 0,
                out_hi - out_lo)
    return img


def write_segment(path: str, seg, cb_bytes: int | None,
                  depth: int = 2, fail_after_windows: int | None = None
                  ) -> None:
    """Write one segment file (``seg``: a uint8 tensor or array); with
    ``cb_bytes`` smaller than the segment, drain it through a
    background writer thread fed one cb window of host bytes at a time
    through ``depth - 1`` queue slots (mirroring the ring's ``depth``
    in-flight window buffers). A single consumer writes the windows in
    order, so the bytes on disk are identical to the direct write for
    every depth.

    Failure semantics (fail fast): the producer checks the drain
    thread's error flag before EVERY enqueue and stops producing the
    moment the drain dies. A failed write leaves the file truncated at
    the last complete window plus a ``<path>.partial`` marker
    (``faults.partial_marker``) so a reader/restart can DETECT the torn
    write, then raises :class:`TornWriteError` (original error as
    ``__cause__``).

    ``fail_after_windows`` is the fault-injection hook: the drain
    thread dies after writing that many windows (forcing the threaded
    path even for single-window segments).
    """
    seg = to_host(seg, np.uint8)
    inject = fail_after_windows is not None
    if not inject and (cb_bytes is None or seg.size <= cb_bytes
                       or depth <= 1):
        with open(path, "wb") as f:
            f.write(seg.tobytes())
        return
    if cb_bytes is None or cb_bytes <= 0:
        cb_bytes = max(int(seg.size), 1)
    q: queue.Queue = queue.Queue(maxsize=max(depth - 1, 1))
    error: list[BaseException] = []
    written = [0]

    def drain(f):
        # after an error, keep consuming (and discarding) so a
        # producer enqueue racing the error flag never blocks on a
        # dead consumer; the producer stops at its next check
        while True:
            chunk = q.get()
            if chunk is None:
                return
            if error:
                continue
            if inject and written[0] >= fail_after_windows:
                error.append(IOError(
                    f"injected drain fault after {written[0]} windows"))
                continue
            try:
                f.write(chunk)
                written[0] += 1
            except BaseException as e:  # noqa: BLE001 - re-raised below
                error.append(e)

    enqueued = 0
    with open(path, "wb") as f:
        th = threading.Thread(target=drain, args=(f,))
        th.start()
        try:
            for lo in range(0, int(seg.size), cb_bytes):
                if error:
                    break          # fail fast: drain died, stop feeding it
                q.put(seg[lo:lo + cb_bytes].tobytes())
                enqueued += 1
        finally:
            q.put(None)
            th.join()
    if error:
        with open(partial_marker(path), "w") as mf:
            mf.write(f"windows_written={written[0]}\n")
        raise TornWriteError(path, enqueued, written[0]) from error[0]


def serve_of(plan, serve_map, stripe_count: int):
    """The domain->slot map: the plan's placement, or a validated
    execution-level ``serve_map`` override."""
    perm = (plan.placement if plan.placement is not None
            else tuple(range(stripe_count)))
    if serve_map is None:
        return tuple(perm)
    serve = tuple(int(s) for s in serve_map)
    if len(serve) != stripe_count or not all(
            0 <= s < stripe_count for s in serve):
        raise ValueError(f"serve_map {serve!r} must map each of "
                         f"{stripe_count} domains to a valid slot")
    return serve


def drain_images(plan, machine, t, offs, lens, data, owner, n_senders_g):
    """The GA side of a write: per domain, merge its inbox (the
    requests it owns, in sender order), sort, coalesce and build its
    image. Charges ``t.inter_sort``; returns the images (uint8 tensors)
    and their lengths (int64, host)."""
    sc = plan.n_aggregators
    ss = plan.layout.stripe_size
    c_off, c_len, packed, c_grp, n_req = merge_coalesce_groups(
        offs, lens, data, owner, sc)
    per_g = torch.bincount(c_grp, minlength=sc).cpu().numpy()
    bytes_g = torch.zeros(sc, dtype=torch.int64, device=offs.device) \
        .index_add_(0, c_grp, c_len).cpu().numpy()
    segs, img_lens = [], np.zeros(sc, np.int64)
    r0 = b0 = 0
    for g in range(sc):
        r1, b1 = r0 + int(per_g[g]), b0 + int(bytes_g[g])
        n_cmp = n_comparisons(int(n_req[g]), int(n_senders_g[g]))
        t.inter_sort = max(t.inter_sort, machine.sort_per_cmp * n_cmp)
        segs.append(domain_image(c_off[r0:r1], c_len[r0:r1],
                                 packed[b0:b1], g, ss, sc, window=plan.cb))
        img_lens[g] = segs[-1].numel()
        r0, b0 = r1, b1
    return segs, img_lens


def execute_write(plan, machine, per_la, path: str, t,
                  depth_request=None, sender_nodes=None,
                  n_nodes: int | None = None, faults=None,
                  heartbeat=None, serve_map=None):
    """Run the inter-node exchange + I/O step of a write plan.

    per_la: the stage-1 output — per local aggregator (per rank for
    two-phase) ``(offsets, lengths, packed)`` tensors in BYTE units,
    already split at stripe boundaries, on the executor's device. ``t``
    is the :class:`IOTimings` being filled (stage-1 fields already set
    by the caller).

    The round partition comes from the plan: round r covers
    domain-local bytes ``[r*cb, (r+1)*cb)`` of every GA (the 1-round
    plan with ``cb == domain_len`` IS the single shot). Each (sender,
    domain, round) with requests is one slow-hop message.

    ``depth_request="auto"`` re-resolves the depth against the MEASURED
    per-round comm/drain arrays (``cost_model.optimal_depth``). With
    ``plan.slow_hop_codec`` set (lossless byte codecs only), every
    message's payload passes through a real host
    ``encode_bytes``/``decode_bytes`` round trip and the incast charges
    the encoded size. ``sender_nodes`` (per ``per_la`` entry) turns on
    the placement-aware accounting: messages from the serving slot's
    node move at the intra rates. ``faults``/``heartbeat``/``serve_map``
    are the reference's fault hooks: node slowdowns, lost and delayed
    messages, a dead aggregator (repair map, replay, torn segment
    rewritten) and a torn drain window; the bytes on disk stay those of
    the healthy run.
    """
    m = machine
    stripe_count, cb = plan.n_aggregators, plan.cb
    stripe_size = plan.layout.stripe_size
    n_rounds = plan.n_rounds
    codec = get_codec(plan.slow_hop_codec) if plan.slow_hop_codec else None
    raw_total = wire_total = 0
    if n_nodes is None and sender_nodes is not None:
        n_nodes = int(max(sender_nodes, default=0)) + 1
    if n_nodes is None and faults is not None and faults.any_node_faults:
        raise ValueError("node-level faults need n_nodes (or "
                         "sender_nodes) to locate the victims")
    serve = serve_of(plan, serve_map, stripe_count)
    serve_nodes = None
    if n_nodes is not None:
        serve_nodes = [placement_mod.node_of_slot(serve[g], stripe_count,
                                                  n_nodes)
                       for g in range(stripe_count)]
    slow_of = (lambda node: faults.slowdown(node)) if faults is not None \
        else (lambda node: 1.0)

    # ---- inter-node: local aggregators -> global aggregators ---------
    offs, lens, sender, data = flatten(per_la)
    owner = (offs // stripe_size) % stripe_count
    rnd = to_domain_local(offs, stripe_size, stripe_count) // cb
    # one message per (sender, domain, round) holding requests; unique
    # sorts the keys in the reference's loop order
    key = (sender * stripe_count + owner) * n_rounds + rnd
    keys, inv = torch.unique(key, sorted=True, return_inverse=True)
    n_msg = keys.numel()
    zeros = torch.zeros(n_msg, dtype=torch.int64, device=offs.device)
    m_req = zeros.index_add(0, inv, torch.ones_like(inv)).cpu().numpy()
    m_pay = zeros.index_add(0, inv, lens).cpu().numpy()
    keys = keys.cpu().numpy()
    m_r = keys % n_rounds
    m_g = (keys // n_rounds) % stripe_count
    m_s = keys // (n_rounds * stripe_count)
    fast = np.zeros(n_msg, bool)
    if sender_nodes is not None:
        s_nodes = np.asarray(sender_nodes, np.int64)[m_s]
        fast = np.asarray(serve_nodes, np.int64)[m_g] == s_nodes
        node_bytes = np.zeros((stripe_count, n_nodes), np.int64)
        np.add.at(node_bytes, (m_g, s_nodes), m_pay)

    # injected message faults: extra seconds charged to (domain, round),
    # added in the reference's (sender, domain, round) order
    penalty = np.zeros((stripe_count, n_rounds))
    matched_lost: set[tuple[int, int]] = set()
    if faults is not None and (faults.lost or faults.delayed):
        hit = set(faults.lost) | set(faults.delayed)
        for i in range(n_msg):
            k = (int(m_s[i]), int(m_r[i]))
            if k not in hit:
                continue
            g, r = int(m_g[i]), int(m_r[i])
            lost_n = int(faults.lost.get(k, 0))
            if lost_n:
                if lost_n > faults.max_retries:
                    raise UnrecoverableFaultError(
                        f"message from sender {k[0]} in round {r} lost "
                        f"{lost_n} times (max_retries={faults.max_retries})")
                matched_lost.add(k)
                # each loss times out (exponential backoff) and re-sends
                # the round's slice
                penalty[g, r] += faults.retry_penalty(lost_n) \
                    + lost_n * (m.alpha_inter + m.beta_inter
                                * (int(m_pay[i]) + int(m_req[i])
                                   * PAIR_BYTES))
            penalty[g, r] += float(faults.delayed.get(k, 0.0))

    wire = m_pay.copy()
    if codec is not None:
        # one host encode per message: its wire size is what the incast
        # charges, and its decode is what the GA receives (byte-identical
        # for the lossless codecs this path admits)
        order = torch.sort(inv, stable=True).indices
        m_start, m_len = exclusive_cumsum(lens)[order], lens[order]
        raw_host = gather_spans(data, m_start, m_len).cpu().numpy()
        dec_host = np.empty_like(raw_host)
        pos = 0
        for i in range(n_msg):
            n = int(m_pay[i])
            w = codec.encode_bytes(raw_host[pos:pos + n])
            dec_host[pos:pos + n] = codec.decode_bytes(w)
            raw_total += n
            wire_total += int(w.size)
            wire[i] = w.size           # the wire moves encoded
            pos += n
        data = data.clone()
        scatter_spans(data, m_start, m_len,
                      torch.from_numpy(dec_host).to(data.device))
    msg_bytes = wire + m_req * PAIR_BYTES
    ga_msgs = np.zeros((stripe_count, n_rounds), np.int64)
    ga_bytes = np.zeros((stripe_count, n_rounds), np.int64)
    ga_msgs_fast = np.zeros((stripe_count, n_rounds), np.int64)
    ga_bytes_fast = np.zeros((stripe_count, n_rounds), np.int64)
    np.add.at(ga_msgs, (m_g[~fast], m_r[~fast]), 1)
    np.add.at(ga_msgs_fast, (m_g[fast], m_r[fast]), 1)
    np.add.at(ga_bytes, (m_g[~fast], m_r[~fast]), msg_bytes[~fast])
    np.add.at(ga_bytes_fast, (m_g[fast], m_r[fast]), msg_bytes[fast])
    t.rounds_executed = n_rounds
    if codec is not None:
        t.slow_hop_codec = codec.name
        t.slow_hop_raw_bytes = int(raw_total)
        t.slow_hop_wire_bytes = int(wire_total)
        t.codec = float(raw_total + wire_total) / m.codec_bw
    t.messages_at_ga = int((ga_msgs + ga_msgs_fast).max(initial=0))
    if sender_nodes is not None:
        t.placement = plan.placement
        t.slow_hop_fast_bytes = int(ga_bytes_fast.sum())
        t.slow_hop_slow_bytes = int(ga_bytes.sum())
        t.node_bytes = tuple(tuple(int(b) for b in row)
                             for row in node_bytes)
    t.retries = sum(int(faults.lost[k]) for k in matched_lost) \
        if faults is not None else 0
    # per-round incast: a receiver with S concurrent SLOW senders pays
    # alpha_eff(S) each; the placement-induced FAST senders pay
    # alpha_intra/beta_intra instead. Domains sharing a serving slot
    # serialize: the round's comm is the max over slots of the sum of
    # their domains' times.
    alpha = np.vectorize(m.alpha_eff)(ga_msgs) * ga_msgs \
        + m.alpha_intra * ga_msgs_fast
    t_dom = (alpha + m.beta_inter * ga_bytes
             + m.beta_intra * ga_bytes_fast + penalty)
    dom_factor = np.ones(stripe_count)
    if serve_nodes is not None:
        dom_factor = np.asarray([slow_of(n) for n in serve_nodes])
    t_dom_served = t_dom * dom_factor[:, None]
    slot_rounds = np.zeros((stripe_count, n_rounds))
    for g in range(stripe_count):
        slot_rounds[serve[g]] += t_dom_served[g]
    comm_rounds = slot_rounds.max(axis=0, initial=0)
    t.inter_comm = float(comm_rounds.sum())

    depth = plan.pipeline_depth
    multi_window = n_rounds > 1

    # ---- I/O step: sort + images ---------------------------------------
    n_senders_g = np.bincount(m_g[np.concatenate(
        [[True], (m_s[1:] != m_s[:-1]) | (m_g[1:] != m_g[:-1])])]
        if n_msg else np.zeros(0, np.int64), minlength=stripe_count)
    segs, img_lens = drain_images(plan, m, t, offs, lens, data, owner,
                                  n_senders_g)

    # bytes GA g drains in round r: its image's overlap with the
    # window [r*cb, (r+1)*cb); the serving node's slowdown scales it
    lo = np.arange(n_rounds, dtype=np.int64) * cb
    io_share = (np.clip(img_lens[:, None] - lo[None, :], 0, cb)
                / m.io_bw) * dom_factor[:, None]
    io_rounds = io_share.sum(axis=0)
    t.io = float(io_share.sum())
    if depth_request == "auto" and multi_window:
        depth, _ = optimal_depth(round_times=(comm_rounds, io_rounds))
    t.pipeline_depth = max(1, min(depth, n_rounds))  # executed in-flight
    t.comm_rounds = tuple(float(c) for c in comm_rounds)
    t.io_rounds = tuple(float(i) for i in io_rounds)

    # ---- measured per-node service rates (the straggler signal) -------
    if serve_nodes is not None:
        served_t = [0.0] * n_nodes
        served_b = [0.0] * n_nodes
        for g in range(stripe_count):
            node = serve_nodes[g]
            served_t[node] += float(t_dom_served[g].sum()
                                    + io_share[g].sum())
            served_b[node] += float(img_lens[g]
                                    + (ga_bytes[g] + ga_bytes_fast[g])
                                    .sum())
        t.node_slowdown = measure_node_slowdown(served_t, served_b)
        t.serve_map = serve if serve_map is not None else None

    # ---- dead aggregator: detection, repair map, replay, torn segment -
    torn_victim, torn_trunc = None, 0
    if faults is not None and faults.dead_aggregator is not None:
        dead_slot, rd = faults.dead_aggregator
        dead_slot = int(dead_slot)
        rd = max(0, min(int(rd), n_rounds - 1))
        victim_node = placement_mod.node_of_slot(dead_slot, stripe_count,
                                                 n_nodes)
        if heartbeat is not None:
            heartbeat.inject_failure(victim_node)
            assert victim_node in heartbeat.dead_hosts()
            detect_s = float(heartbeat.timeout_s)
        else:
            detect_s = float(faults.detection_s)
        slot_load = [0.0] * stripe_count
        for g in range(stripe_count):
            slot_load[serve[g]] += float(t_dom_served[g].sum()
                                         + io_share[g].sum())
        new_serve, repair_slot, victims = repair_map(
            serve, dead_slot, slot_load, stripe_count, n_nodes)
        repair_factor = slow_of(placement_mod.node_of_slot(
            repair_slot, stripe_count, n_nodes))
        replay = 0.0
        for g in victims:
            replay += float(t_dom[g, rd:].sum()) * repair_factor
            replay += float(io_share[g, rd:].sum() / dom_factor[g]) \
                * repair_factor
        t.recovery_seconds += detect_s + replay
        t.repair_map = new_serve
        t.serve_map = new_serve
        serve = new_serve
        if victims:
            torn_victim = victims[0]
            torn_trunc = int(min(rd * cb, img_lens[torn_victim])) \
                if multi_window else 0

    for g in range(stripe_count):
        seg_path = f"{path}.seg{g}"
        cbw = cb if multi_window and depth > 1 else None
        seg = to_host(segs[g], np.uint8)
        if g == torn_victim:
            with open(seg_path, "wb") as f:
                f.write(seg[:torn_trunc].tobytes())
            with open(partial_marker(seg_path), "w") as mf:
                mf.write(f"windows_written={torn_trunc // max(cb, 1)}\n")
        else:
            inject = None
            if faults is not None and faults.torn_window is not None \
                    and g == faults.torn_window[0]:
                inject = int(faults.torn_window[1])
            try:
                write_segment(seg_path, seg, cbw, depth=depth,
                              fail_after_windows=inject)
            except TornWriteError:
                if inject is None:
                    raise      # a REAL drain failure is not recoverable
        if os.path.exists(partial_marker(seg_path)):
            # torn-write repair: the marker is the detection; rewrite
            # the full segment and clear it, charging the re-drain
            write_segment(seg_path, seg, cbw, depth=depth)
            os.remove(partial_marker(seg_path))
            t.torn_writes_detected += 1
            t.recovery_seconds += float(img_lens[g]) / m.io_bw

    _charge_overlap(t, comm_rounds, io_rounds, depth, n_rounds)
    return t


def _charge_overlap(t, comm_rounds, io_rounds, depth, n_rounds) -> None:
    """The depth-k bounded-buffer makespan over the measured per-round
    arrays; the prologue (first exchange) and epilogue (last drain) stay
    exposed."""
    if depth > 1 and n_rounds > 0:
        serial = float(comm_rounds.sum() + io_rounds.sum())
        span = pipeline_span(comm_rounds, io_rounds, depth)
        t.overlap_saved = max(serial - span, 0.0)
        hideable = (float(min(comm_rounds[1:].sum(),
                              io_rounds[:-1].sum()))
                    if n_rounds > 1 else 0.0)
        t.overlap_fraction = (min(t.overlap_saved / hideable, 1.0)
                              if hideable > 0 else 0.0)


def read_spans(rank_requests, stripe_size: int, stripe_count: int,
               cb: int):
    """Every reader request cut at cb windows, as int64 host arrays in
    the reference's span order (rank, request, window): ``rank, g, r,
    wo, take, out`` (``out``: the span's position in the concatenation
    of every rank's output), plus the bytes each rank reads. Requests
    are per rank ``(offsets, lengths)`` tensors or arrays in bytes."""
    offs = np.concatenate([to_host(o, np.int64) for o, _ in rank_requests]
                          + [np.zeros(0, np.int64)])
    lens = np.concatenate([to_host(ln, np.int64) for _, ln in rank_requests]
                          + [np.zeros(0, np.int64)])
    counts = np.asarray([len(o) for o, _ in rank_requests],
                        np.int64)
    rank = np.repeat(np.arange(len(rank_requests), dtype=np.int64), counts)
    totals = np.zeros(len(rank_requests), np.int64)
    np.add.at(totals, rank, lens)
    g = (offs // stripe_size) % stripe_count
    dl = to_domain_local(offs, stripe_size, stripe_count)
    r0 = dl // cb
    n_sp = np.where(lens > 0, (dl + lens - 1) // cb - r0 + 1, 0)
    idx = np.repeat(np.arange(offs.size), n_sp)
    j = np.arange(idx.size) - np.repeat(np.cumsum(n_sp) - n_sp, n_sp)
    r = r0[idx] + j
    lo = np.maximum(dl[idx], r * cb)
    hi = np.minimum(dl[idx] + lens[idx], (r + 1) * cb)
    out = (np.cumsum(lens) - lens)[idx] + (lo - dl[idx])
    return (rank[idx], g[idx], r, lo - r * cb, hi - lo, out), totals


def window_runs(win, wo, take, cb: int):
    """The requested byte runs of each window, overlapping or touching
    spans merged (the reference's run merge): ``(win, lo, hi)`` int64
    arrays sorted by window, then position."""
    order = np.lexsort((take, wo, win))
    w, lo = win[order], wo[order]
    hi = lo + take[order]
    stride = 2 * cb + 2
    g_lo, g_hi = w * stride + lo, w * stride + hi
    prev_hi = np.maximum.accumulate(g_hi)
    new = np.ones(w.size, bool)
    new[1:] = g_lo[1:] > prev_hi[:-1]
    head = np.flatnonzero(new)
    run_hi = np.maximum.reduceat(g_hi, head) if head.size else head
    return w[head], lo[head], run_hi - w[head] * stride


def execute_read(plan, machine, rank_requests, path: str, t, *,
                 n_nodes: int, ranks_per_node: int, depth_request=None,
                 node_cache: bool = True, serve_map=None, faults=None,
                 device=None):
    """Run the I/O + fan-out step of a read plan (the write's mirror).

    rank_requests: per READER rank ``(offsets, lengths)`` in bytes,
    already split at stripe boundaries. Rank i lives on node
    ``i // ranks_per_node``. Returns the per-rank payloads (one uint8
    tensor per rank on ``device``, request order) with ``t`` filled.
    Bytes are REAL: every window any rank needs is read from its
    segment file with RANGED reads of the requested runs only
    (``t.read_bytes``), zeros past the segment's written extent, and
    each rank's bytes are gathered from the windows on the device.
    TIME is modeled, as in :func:`execute_write`.

    ``node_cache=True``: per (window, needing node) the node's elected
    fetcher (its lowest needing rank) pulls the window over the slow
    hop ONCE (``t.cache_misses``) and co-located readers are served
    from the node's cache at the intra rates (``t.cache_hits``).
    ``node_cache=False``: every needing rank pulls the whole window.
    With ``plan.slow_hop_codec`` set, each window crossing the slow hop
    passes a real host encode/decode round trip. A ``<seg>.partial``
    marker on any needed segment raises :class:`TornWriteError`.
    """
    m = machine
    stripe_count, cb = plan.n_aggregators, plan.cb
    stripe_size = plan.layout.stripe_size
    n_rounds = plan.n_rounds
    codec = get_codec(plan.slow_hop_codec) if plan.slow_hop_codec else None
    serve = serve_of(plan, serve_map, stripe_count)
    serve_nodes = [placement_mod.node_of_slot(serve[g], stripe_count,
                                              n_nodes)
                   for g in range(stripe_count)]
    slow_of = (lambda node: faults.slowdown(node)) if faults is not None \
        else (lambda node: 1.0)
    if device is None:
        device = next((o.device for o, _ in rank_requests
                       if isinstance(o, torch.Tensor)), torch.device("cpu"))

    # ---- demand map: which (domain, window) does each rank/node need --
    (s_rank, s_g, s_r, s_wo, s_take, s_out), totals = read_spans(
        rank_requests, stripe_size, stripe_count, cb)
    s_nd = s_rank // ranks_per_node
    node_bytes = np.zeros((stripe_count, n_nodes), np.int64)
    np.add.at(node_bytes, (s_g, s_nd), s_take)
    wkey = s_g * n_rounds + s_r
    wins, s_win = np.unique(wkey, return_inverse=True)
    w_g, w_r = wins // n_rounds, wins % n_rounds

    # ---- ranged segment reads of the requested runs, once per window --
    needed_gs = sorted(set(int(g) for g in w_g))
    for g in needed_gs:
        if os.path.exists(partial_marker(f"{path}.seg{g}")):
            raise TornWriteError(f"{path}.seg{g}", -1, -1)
    seg_len = {g: (os.path.getsize(f"{path}.seg{g}")
                   if os.path.exists(f"{path}.seg{g}") else 0)
               for g in needed_gs}
    windows = np.zeros((wins.size, cb), np.uint8)
    got = np.zeros(wins.size, np.int64)
    io_share = np.zeros((stripe_count, n_rounds))
    run_w, run_lo, run_hi = window_runs(s_win, s_wo, s_take, cb)
    handles = {g: (open(f"{path}.seg{g}", "rb") if seg_len[g] else None)
               for g in needed_gs}
    try:
        for w, lo, hi in zip(run_w, run_lo, run_hi):
            g, base = int(w_g[w]), int(w_r[w]) * cb
            take = min(base + int(hi), seg_len[g]) - (base + int(lo))
            if take > 0:
                handles[g].seek(base + int(lo))
                windows[w, lo:lo + take] = np.frombuffer(
                    handles[g].read(take), np.uint8)
                got[w] += take
    finally:
        for f in handles.values():
            if f is not None:
                f.close()
    for w in range(wins.size):
        g, r = int(w_g[w]), int(w_r[w])
        t.read_bytes += int(got[w])
        io_share[g, r] = got[w] / m.io_bw * slow_of(serve_nodes[g])

    # ---- per (window, node): its readers, the elected fetcher ---------
    n_rank_keys = int(s_rank.max(initial=0)) + 1
    q_key = (s_win * n_nodes + s_nd) * n_rank_keys + s_rank
    quads, q_inv = np.unique(q_key, return_inverse=True)
    q_bytes = np.zeros(quads.size, np.int64)
    np.add.at(q_bytes, q_inv, s_take)
    trip, t_first, t_n = np.unique(quads // n_rank_keys, return_index=True,
                                   return_counts=True)
    t_win, t_nd = trip // n_nodes, trip % n_nodes
    t_bytes = np.add.reduceat(q_bytes, t_first) if trip.size else q_bytes
    # quads sort by rank within a (window, node): the first is the fetcher
    t_fetch_bytes = q_bytes[t_first]

    raw_b = cb + PAIR_BYTES
    wire_b = np.full(wins.size, raw_b, np.int64)
    raw_total = wire_total = 0
    if codec is not None:
        for w in range(wins.size):
            nds = t_nd[t_win == w]
            if any(serve_nodes[int(w_g[w])] != nd for nd in nds):
                # encoded ONCE at the serving aggregator; every slow
                # receiver consumes the round-tripped window
                wire = codec.encode_bytes(windows[w])
                windows[w] = np.asarray(codec.decode_bytes(wire), np.uint8)
                raw_total += int(windows[w].size)
                wire_total += int(wire.size)
                wire_b[w] = int(wire.size) + PAIR_BYTES

    tg, tr = w_g[t_win], w_r[t_win]
    fast = np.asarray(serve_nodes, np.int64)[tg] == t_nd
    ga_msgs = np.zeros((stripe_count, n_rounds), np.int64)
    ga_bytes = np.zeros((stripe_count, n_rounds), np.int64)
    ga_msgs_fast = np.zeros((stripe_count, n_rounds), np.int64)
    ga_bytes_fast = np.zeros((stripe_count, n_rounds), np.int64)
    fan_msgs = np.zeros((n_nodes, n_rounds), np.int64)
    fan_bytes = np.zeros((n_nodes, n_rounds), np.int64)
    stage_bytes = np.zeros(n_nodes, np.int64)
    n_fetch = np.ones_like(t_n) if node_cache else t_n
    np.add.at(ga_msgs_fast, (tg[fast], tr[fast]), n_fetch[fast])
    np.add.at(ga_bytes_fast, (tg[fast], tr[fast]), raw_b * n_fetch[fast])
    np.add.at(ga_msgs, (tg[~fast], tr[~fast]), n_fetch[~fast])
    np.add.at(ga_bytes, (tg[~fast], tr[~fast]),
              wire_b[t_win[~fast]] * n_fetch[~fast])
    if node_cache:
        t.cache_misses += int(trip.size)
        t.cache_hits += int((t_n - 1).sum())
        np.add.at(stage_bytes, t_nd, cb)
        np.add.at(fan_msgs, (t_nd, tr), t_n - 1)
        np.add.at(fan_bytes, (t_nd, tr), t_bytes - t_fetch_bytes)
    else:
        t.cache_misses += int(t_n.sum())

    t.rounds_executed = n_rounds
    if codec is not None:
        t.slow_hop_codec = codec.name
        t.slow_hop_raw_bytes = int(raw_total)
        t.slow_hop_wire_bytes = int(wire_total)
        t.codec = float(raw_total + wire_total) / m.codec_bw
    t.messages_at_ga = int((ga_msgs + ga_msgs_fast).max(initial=0))
    t.placement = plan.placement
    t.slow_hop_fast_bytes = int(ga_bytes_fast.sum())
    t.slow_hop_slow_bytes = int(ga_bytes.sum())
    t.node_bytes = tuple(tuple(int(b) for b in row) for row in node_bytes)

    # per-round outcast at the serving aggregator (the incast knee is
    # symmetric); same-node deliveries move at intra rates; domains
    # sharing a serving slot serialize as in the write path
    alpha = np.vectorize(m.alpha_eff)(ga_msgs) * ga_msgs \
        + m.alpha_intra * ga_msgs_fast
    t_dom = (alpha + m.beta_inter * ga_bytes
             + m.beta_intra * ga_bytes_fast)
    dom_factor = np.asarray([slow_of(n) for n in serve_nodes])
    t_dom_served = t_dom * dom_factor[:, None]
    slot_rounds = np.zeros((stripe_count, n_rounds))
    for g in range(stripe_count):
        slot_rounds[serve[g]] += t_dom_served[g]
    fetch_rounds = slot_rounds.max(axis=0, initial=0)
    # the fan-out runs per node in parallel; round r's comm closes when
    # the slowest node has delivered its cached windows
    fan_rounds = (m.alpha_intra * fan_msgs
                  + m.beta_intra * fan_bytes).max(axis=0, initial=0)
    comm_rounds = fetch_rounds + fan_rounds
    t.inter_comm = float(fetch_rounds.sum())
    t.intra_comm = float(fan_rounds.sum())
    t.intra_memcpy = float(stage_bytes.max(initial=0)) / m.memcpy_bw
    io_rounds = io_share.sum(axis=0)
    t.io = float(io_share.sum())

    depth = plan.pipeline_depth
    if depth_request == "auto" and n_rounds > 1:
        depth, _ = optimal_depth(round_times=(comm_rounds, io_rounds))
    t.pipeline_depth = max(1, min(depth, n_rounds))
    t.comm_rounds = tuple(float(c) for c in comm_rounds)
    t.io_rounds = tuple(float(i) for i in io_rounds)

    served_t = [0.0] * n_nodes
    served_b = [0.0] * n_nodes
    for g in range(stripe_count):
        node = serve_nodes[g]
        served_t[node] += float(t_dom_served[g].sum() + io_share[g].sum())
        served_b[node] += float((ga_bytes[g] + ga_bytes_fast[g]).sum())
    t.node_slowdown = measure_node_slowdown(served_t, served_b)
    t.serve_map = serve if serve_map is not None else None
    _charge_overlap(t, comm_rounds, io_rounds, depth, n_rounds)
    return assemble_reads(windows, s_win, s_wo, s_take, totals, cb, device)


def assemble_reads(windows: np.ndarray, s_win, s_wo, s_take, totals,
                   cb: int, device) -> list:
    """Every rank's bytes gathered from the fetched windows on
    ``device``: spans come in output order, so the concatenation of the
    ranks' outputs is one gather. Returns one uint8 tensor per rank."""
    win_t = torch.from_numpy(windows.reshape(-1)).to(device)
    take = torch.from_numpy(s_take).to(device)
    flat = gather_spans(win_t, torch.from_numpy(s_win * cb + s_wo).to(device),
                        take)
    return list(torch.split(flat, [int(n) for n in totals]))
