"""Round-scheduled bounded-buffer exchange engine (port of
``repro.core.rounds``).

Aggregator ``g`` owns the contiguous file domain
``[g * domain_len, (g+1) * domain_len)``; :class:`RoundScheduler`
partitions every domain into ``domain_len / cb`` windows and round ``t``
moves exactly the requests whose offsets fall in window ``t`` of their
destination domain: split at window boundaries once, then per round
select → bucket → exchange → drain (sort, pack the window and its
coverage mask, masked-max merge over the node's receive streams,
accumulate at ``t * cb``).

One device, the rank as a tensor axis
-------------------------------------
The reference runs this inside a ``shard_map`` over a
``(node, lagg, lmem)`` mesh. The port keeps all P ranks on one device,
rank p = ``(node, lagg, lmem)`` in row-major order as the leading axis
of every tensor, and each collective becomes a tensor op:

* ``all_to_all`` over ``node`` — a transpose of the ``[N, ..., n_dest,
  cap]`` buckets (:func:`_a2a`);
* ``pmax`` / ``psum`` over the merge axes — ``amax`` / ``sum`` over
  those dims;
* ``all_gather`` over ``lmem`` — a reshape to ``[N * A, M, ...]``;
* ``ppermute`` — indexing by the placement permutation;
* ``lax.fori_loop`` — a Python loop; ``dynamic_update_slice`` — slice
  assignment.

TAM runs once per ``(node, lagg)`` group. Under SPMD every ``lmem`` slot
redundantly runs stage 1 and stage 2 on the same gathered aggregate; on
one device that replication would multiply memory by M, so the port
computes each replicated quantity once per group and reports the stats
the reference reports (``spmd_exec`` divides by the lmem size where the
reference does). The two-phase drains are not replicated: every rank
drains its own slice, all P in one batched kernel call.

The depth-k ring (``depth``) keeps the reference's schedule — prologue
exchanges rounds 0..k-2, the steady state exchanges round t while
draining round t-(k-1), the epilogue drains the rest — so every round
passes through the identical drain exactly once, in order.

The slow-hop codec (:func:`_codec_hooks`) wraps only the node-axis
hop: each exchange encodes its payload buckets before the transpose
and the drain decodes them; ``ef-int8``'s residual is threaded through
the round loop in round order at every depth.

The read (:func:`exchange_rounds_read`) runs the other way: per round
every aggregator's ``cb`` window is encoded, "broadcast" (on one device
the ``[n_dest, cb]`` windows are simply computed once) and decoded, and
every rank gathers the elements of its requests that fall in it.
"""
from __future__ import annotations

import math

import torch

from repro_torch import trace
from repro_torch.core import coalesce as co
from repro_torch.core import codec as codec_mod
from repro_torch.core import placement as placement_mod
from repro_torch.core._tensor import (repeat_index, stable_partition_order,
                                      wrap_int32)
from repro_torch.core.exchange import (bucket_by_dest, flatten_buckets,
                                       repack_sorted, sort_with)
from repro_torch.core.plan import RoundScheduler  # noqa: F401
from repro_torch.core.requests import PAD_OFFSET, RequestList, split_at_stripes


def _codec_hooks(slow_hop_codec: str | None, dtype, state_shape, device,
                 fused: bool = False):
    """(encode, decode, state0) for the slow-hop wire transform.

    ``encode(data, state) -> (wire_parts, state)`` runs inside the
    ``exchange`` closure BEFORE the node-axis transpose;
    ``decode(wire_parts) -> data`` runs inside the drain (and the read
    fetch). ``state0`` is the codec's residual (the empty tuple for
    stateless codecs). A lossy codec on a non-float payload raises
    ``TypeError`` here, before any round runs.

    ``fused`` (``IOPlan.kernel_fusion == "fused_round"``) swaps the rle
    codec's stable-partition compaction for the ``zero_skip_encode``
    kernel and its staged decode scatter for ``zero_skip_decode``
    (``kernels.ops.rle_zero_skip_encode/decode``): the same wire and
    window, byte for byte.
    """
    if slow_hop_codec is None:
        return (lambda data, st: ((data,), st),
                lambda parts: parts[0], ())
    c = codec_mod.get_codec(slow_hop_codec)
    if not c.lossless and not dtype.is_floating_point:
        raise TypeError(
            f"slow_hop_codec={c.name!r} is lossy (float payloads only) "
            f"but the payload dtype is {dtype}")
    state0 = (c.init_state(state_shape, dtype, device) if c.stateful
              else ())
    if fused and c.name == "rle":
        from repro_torch.kernels import ops as kops

        def enc(data, st):
            return kops.rle_zero_skip_encode(data), st

        return enc, kops.rle_zero_skip_decode, state0
    return c.tensor_encode, c.tensor_decode, state0


def _placement_hooks(placement, n_dest: int, dl: int, device):
    """(to_slot, base0, unpermute) for an aggregator placement.

    ``to_slot(domain_idx)`` maps each request's destination DOMAIN to the
    SLOT serving it; ``base0[s]`` is the base offset of the domain slot
    s serves (slot s serves domain ``inv[s]``); ``unpermute(x)`` puts the
    per-slot results on the node axis (dim 0) back into domain order,
    the reference's ``ppermute`` from slot s to slot ``inv[s]``:
    ``out[g] = x[perm[g]]``. The identity placement is the identity.
    """
    slots = torch.arange(n_dest, device=device, dtype=torch.int64)
    if placement_mod.is_identity(placement):
        return (lambda d: d, slots * dl, lambda x: x)
    perm = placement_mod.validate_placement(placement, n_dest)
    inv = placement_mod.inverse_placement(perm)
    perm_t = torch.tensor(perm, dtype=torch.int64, device=device)
    inv_t = torch.tensor(inv, dtype=torch.int64, device=device)

    def to_slot(domain_idx):
        return perm_t[domain_idx.clamp(0, n_dest - 1)]

    return to_slot, inv_t * dl, lambda x: x[perm_t]


def _effective_depth(pipeline: bool, depth: int | None) -> int:
    """Resolve the (pipeline, depth) sugar: an explicit ``depth`` wins;
    the ``pipeline`` bool alone means the classic double buffer."""
    if depth is not None:
        return max(1, int(depth))
    return 2 if pipeline else 1


def _compact_active(r: RequestList, starts: torch.Tensor,
                    dest: torch.Tensor, active: torch.Tensor):
    """Move the active requests to the front, preserving offset order."""
    off = torch.where(active, r.offsets, PAD_OFFSET)
    ln = torch.where(active, r.lengths, 0)
    order = stable_partition_order(active)
    return (RequestList(off.gather(-1, order), ln.gather(-1, order),
                        active.sum(dim=-1, dtype=torch.int32)),
            starts.gather(-1, order), dest.gather(-1, order))


def _lowest(dtype) -> float | int:
    if dtype.is_floating_point:
        return -math.inf
    return torch.iinfo(dtype).min


def _a2a(x: torch.Tensor) -> torch.Tensor:
    """``all_to_all`` over the node axis: ``[N, G, n_dest, ...]`` sent
    buckets become ``[n_dest, G, N_src, ...]`` received buckets (bucket d
    of node n lands at node d, from source n). A per-row wire part
    (``[N, G, n_dest]``, no capacity axis) moves the same way."""
    return x.transpose(0, 2).contiguous()


def _send(parts, n_nodes: int, group: int):
    """Each of the sender-major ``[N * G, n_dest, ...]`` parts through
    :func:`_a2a`, counted in ``slow_hop_bytes``."""
    trace.count("slow_hop_bytes",
                sum(x.numel() * x.element_size() for x in parts))
    return tuple(_a2a(x.reshape(n_nodes, group, *x.shape[1:]))
                 for x in parts)


def _make_drain(base0: torch.Tensor, cb: int, dtype, fused: bool, decode):
    """Drain closure: merge one round's received buckets into the domain
    buffer (decode the wire → flatten → sort → pack window and mask →
    masked-max merge over the receive streams → accumulate at
    ``t * cb``).

    ``rx`` is ``(offsets, lengths, counts, *wire_parts)`` shaped
    ``[n_slots, X, n_src, ...]``: X receive streams per slot (the
    ranks of a node for two-phase, the local aggregators for TAM)
    merged with the reference's masked ``pmax``. ``decode`` inverts the
    slow-hop codec's encode (:func:`_codec_hooks`). ``fused`` (``IOPlan.kernel_fusion == "fused_round"``)
    runs sort + dual pack as one ``fused_sort_pack`` call over all
    ``n_slots * X`` windows; the unfused path is the stable argsort plus
    two scatter packs.
    """
    low = _lowest(dtype)

    def drain(t, buf, rx):
        data = decode(rx[3:]).to(dtype)
        rx = rx[:3]                  # frees the decoded wire parts
        merged, starts_m, data_flat = flatten_buckets(*rx, data)
        base = (base0 + t * cb).unsqueeze(-1).expand(merged.count.shape)
        if fused:
            from repro_torch.kernels import ops as kops
            win, mask = kops.fused_drain_pack(merged, starts_m, data_flat,
                                              base, cb)
        else:
            sorted_r, starts_s = sort_with(merged, starts_m)
            win = co.pack_data(sorted_r, starts_s, data_flat, cb, base=base)
            mask = co.pack_data(sorted_r, starts_s,
                                torch.ones_like(data_flat), cb, base=base)
        covered = mask != 0
        del mask
        comb = torch.where(covered, win, low).amax(dim=1)
        del win
        anyw = covered.any(dim=1)
        buf[:, t * cb:(t + 1) * cb] = torch.where(anyw, comb, 0).to(dtype)
        return buf, (merged.count,)

    return drain


def _run_rounds(n_rounds: int, buf: torch.Tensor, exchange, drain,
                depth: int, codec_state=()):
    """Drive the round loop: serial (depth 1) or a depth-k window ring.

    ``exchange(t, cstate) -> (rx, ex_stats, cstate)`` produces round t's
    received buckets and the advanced codec state (the slow-hop codec's
    residual, the empty tuple when stateless); ``drain(t, buf, rx) ->
    (buf, dr_stats)`` merges them into the domain buffer. Stats tuples
    are summed elementwise over rounds. Ring schedule (depth k, clamped
    to the round count): the prologue exchanges rounds 0..k-2; iteration
    t exchanges round t while draining round t-(k-1); the epilogue
    drains the remaining k-1. Exchanges run in round order, so error
    feedback sees rounds 0, 1, 2, ... at every depth.
    """
    ex_acc = dr_acc = None

    def add(acc, delta):
        return delta if acc is None else tuple(
            a + d for a, d in zip(acc, delta))

    d = max(1, min(depth, n_rounds))
    ring = []
    cst = codec_state
    for t in range(n_rounds):
        with trace.span("repro_torch.exchange"):
            rx, ex, cst = exchange(t, cst)
        ex_acc = add(ex_acc, ex)
        ring.append(rx)
        if len(ring) == d:
            with trace.span("repro_torch.drain"):
                buf, dr = drain(t - (d - 1), buf, ring.pop(0))
            dr_acc = add(dr_acc, dr)
    for j, rx in enumerate(ring):                # epilogue: drain the ring
        with trace.span("repro_torch.drain"):
            buf, dr = drain(n_rounds - len(ring) + j, buf, rx)
        dr_acc = add(dr_acc, dr)
    return buf, ex_acc, dr_acc


def exchange_rounds_write(sched: RoundScheduler, dims: tuple[int, int, int],
                          r: RequestList, starts: torch.Tensor,
                          data: torch.Tensor, pipeline: bool = False,
                          depth: int | None = None,
                          slow_hop_codec: str | None = None,
                          placement=None,
                          kernel_fusion: str | None = None):
    """Round loop of the two-phase collective write over all ranks.

    dims: the mesh ``(N, A, M)``; r/starts/data: every rank's
    offset-sorted requests ``[P, cap]``, payload starts and packed
    payload ``[P, data_cap]``, rank p = (node, lagg, lmem) row-major.
    Returns ``(file [n_dest, domain_len] in domain order, stats)``:
    per-rank drop counts ``[P]`` and ``requests_at_ga [n_dest]``
    (summed over each node's ranks, in domain order).
    ``slow_hop_codec`` encodes each round's payload buckets around the
    node-axis transpose; with ``kernel_fusion="fused_round"`` and
    ``"rle"`` the zero-skip kernels encode and decode the wire.
    """
    fused = kernel_fusion == "fused_round"
    n_nodes, n_lagg, n_lmem = dims
    n_dest, cb, dl = sched.n_aggregators, sched.cb, sched.domain_len
    if n_dest != n_nodes:
        raise ValueError(f"{n_dest} aggregators but {n_nodes} nodes")
    data_cap = data.shape[-1]
    split = split_at_stripes(r, cb, sched.max_spans(data_cap))
    s_starts = co.request_starts(split)
    to_slot, base0, unpermute = _placement_hooks(placement, n_dest, dl,
                                                 data.device)
    dest = to_slot(split.offsets.to(torch.int64) // dl)
    window = sched.window_of(split.offsets)
    live = split.valid_mask()
    round_req_cap = min(split.capacity, cb)
    round_data_cap = min(data_cap, cb)
    group = n_lagg * n_lmem
    enc, dec, cstate0 = _codec_hooks(
        slow_hop_codec, data.dtype, (data.shape[0], n_dest, round_data_cap),
        data.device, fused=fused)

    def exchange(t, cst):
        with trace.span("repro_torch.select"):
            act_r, act_starts, act_dest = _compact_active(
                split, s_starts, dest, live & (window == t))
        with trace.span("repro_torch.route"):
            act_data = repack_sorted(act_r, act_starts, data, data_cap)
        with trace.span("repro_torch.bucket"):
            b = bucket_by_dest(act_r, co.request_starts(act_r), act_data,
                               act_dest, n_dest, round_req_cap,
                               round_data_cap)
        del act_data
        meta = (b.offsets, b.lengths, b.counts)
        stats = (b.dropped_requests, b.dropped_elems)
        with trace.span("repro_torch.send"):
            wire, cst = enc(b.data, cst)
            del b                    # the payload buckets are encoded
            rx = _send(meta, n_nodes, group) + _send(wire, n_nodes, group)
        return rx, stats, cst

    drain = _make_drain(base0, cb, data.dtype, fused, dec)
    buf = torch.zeros((n_dest, dl), dtype=data.dtype, device=data.device)
    buf, (drop_r, drop_e), (reqs_rx,) = _run_rounds(
        sched.n_rounds, buf, exchange, drain,
        _effective_depth(pipeline, depth), codec_state=cstate0)
    return unpermute(buf), {
        "dropped_requests": drop_r,
        "dropped_elems": drop_e,
        "requests_at_ga": unpermute(reqs_rx.sum(dim=1, dtype=torch.int32)),
    }


def exchange_rounds_write_tam(sched: RoundScheduler,
                              dims: tuple[int, int, int], r: RequestList,
                              starts: torch.Tensor, data: torch.Tensor,
                              coalesce_cap: int | None = None,
                              use_kernels: bool = False,
                              pipeline: bool = False,
                              depth: int | None = None,
                              slow_hop_codec: str | None = None,
                              placement=None,
                              kernel_fusion: str | None = None):
    """Fused TAM round loop: BOTH aggregation layers run per window.

    Per round t, stage 1 gathers the window's requests of the M ranks of
    each ``(node, lagg)`` group (per-rank payload bounded at
    ``min(data_cap, cb)``), the group's local aggregator sorts,
    coalesces and repacks that window — with the ``bitonic_sort`` and
    ``coalesce`` kernels when ``use_kernels`` — and stage 2 exchanges the
    coalesced window over the node axis, merged over ``lagg``.

    Returns ``(file [n_dest, domain_len], stats)``: ``*_rank`` drop
    stats per rank ``[P]``; ``*_agg`` drops and the before/after
    coalesce counts per group ``[N * A]`` (computed once per group, not
    replicated over lmem); ``requests_at_ga [n_dest]``. The slow-hop
    codec wraps only stage 2's node-axis hop, as in
    :func:`exchange_rounds_write`; the intra-node gather stays raw.
    """
    fused = kernel_fusion == "fused_round"
    n_nodes, n_lagg, n_lmem = dims
    n_groups = n_nodes * n_lagg
    n_dest, cb, dl = sched.n_aggregators, sched.cb, sched.domain_len
    if n_dest != n_nodes:
        raise ValueError(f"{n_dest} aggregators but {n_nodes} nodes")
    data_cap = data.shape[-1]
    split = split_at_stripes(r, cb, sched.max_spans(data_cap))
    s_starts = co.request_starts(split)
    dest0 = split.offsets.to(torch.int64) // dl
    window = sched.window_of(split.offsets)
    live = split.valid_mask()
    rcap = min(split.capacity, cb)       # stage-1 requests/rank/round
    rdcap = min(data_cap, cb)            # stage-1 payload/rank/round
    # placement routes only the slow hop (stage 2)
    to_slot, base0, unpermute = _placement_hooks(placement, n_dest, dl,
                                                 data.device)
    idx = torch.arange(split.capacity, device=data.device)
    m_cap = n_lmem * rdcap
    enc, dec, cstate0 = _codec_hooks(
        slow_hop_codec, data.dtype, (n_groups, n_dest, min(m_cap, cb)),
        data.device, fused=fused)

    def exchange(t, cst):
        # ---- stage 1: window-bounded intra-node aggregation ---------
        with trace.span("repro_torch.select"):
            act_r, act_starts, _ = _compact_active(split, s_starts, dest0,
                                                   live & (window == t))
            drop_rank_r = (act_r.count - rcap).clamp(min=0)
            drop_rank_e = torch.where(idx >= rcap, act_r.lengths, 0).sum(
                dim=-1, dtype=torch.int32)
            win_r = RequestList(act_r.offsets[:, :rcap],
                                act_r.lengths[:, :rcap],
                                act_r.count.clamp(max=rcap))
            drop_rank_e = drop_rank_e + (
                win_r.lengths.sum(dim=-1, dtype=torch.int32)
                - rdcap).clamp(min=0)
        with trace.span("repro_torch.route"):
            win_data = repack_sorted(win_r, act_starts[:, :rcap], data,
                                     rdcap)
        with trace.span("repro_torch.intranode"):
            # all_gather over lmem: one row per (node, lagg) group
            merged, starts_m, data_flat = flatten_buckets(
                win_r.offsets.reshape(n_groups, n_lmem, rcap),
                win_r.lengths.reshape(n_groups, n_lmem, rcap),
                win_r.count.reshape(n_groups, n_lmem),
                win_data.reshape(n_groups, n_lmem, rdcap))
            del win_data
            if use_kernels:
                from repro_torch.kernels import ops as kops
                sorted_r, starts_s = kops.sort_requests_with(merged,
                                                             starts_m)
                packed = repack_sorted(sorted_r, starts_s, data_flat, m_cap)
                coal = kops.coalesce(sorted_r)
            else:
                sorted_r, starts_s = sort_with(merged, starts_m)
                packed = repack_sorted(sorted_r, starts_s, data_flat, m_cap)
                coal = co.coalesce_sorted(sorted_r)
            del data_flat
            ccap = min(coalesce_cap or coal.capacity, coal.capacity)
            drop_agg_r = (coal.count - ccap).clamp(min=0)
            agg = RequestList(coal.offsets[:, :ccap], coal.lengths[:, :ccap],
                              coal.count.clamp(max=ccap))
            # a coalesced run can escape its window only when cb == dl:
            # re-split at the domain boundary so each piece has one owner
            agg = split_at_stripes(agg, dl, m_cap // dl + 2)
        # ---- stage 2: slow-axis exchange of the coalesced window ----
        with trace.span("repro_torch.bucket"):
            dest = to_slot(agg.offsets.to(torch.int64) // dl)
            b = bucket_by_dest(agg, co.request_starts(agg), packed, dest,
                               n_dest, min(agg.capacity, cb), min(m_cap, cb))
        del packed
        with trace.span("repro_torch.send"):
            wire, cst = enc(b.data, cst)
            rx = (_send((b.offsets, b.lengths, b.counts), n_nodes, n_lagg)
                  + _send(wire, n_nodes, n_lagg))
        return rx, (drop_rank_r, drop_rank_e,
                    b.dropped_requests + drop_agg_r, b.dropped_elems,
                    merged.count, agg.count), cst

    drain = _make_drain(base0, cb, data.dtype, fused, dec)
    buf = torch.zeros((n_dest, dl), dtype=data.dtype, device=data.device)
    buf, ex_acc, (reqs_rx,) = _run_rounds(
        sched.n_rounds, buf, exchange, drain,
        _effective_depth(pipeline, depth), codec_state=cstate0)
    (drop_rank_r, drop_rank_e, drop_agg_r, drop_agg_e,
     n_before, n_after) = ex_acc
    return unpermute(buf), {
        "dropped_requests_rank": drop_rank_r,
        "dropped_elems_rank": drop_rank_e,
        "dropped_requests_agg": drop_agg_r,
        "dropped_elems_agg": drop_agg_e,
        "requests_before_coalesce": n_before,
        "requests_after_coalesce": n_after,
        "requests_at_ga": unpermute(reqs_rx.sum(dim=1, dtype=torch.int32)),
    }


def exchange_rounds_read(sched: RoundScheduler, r: RequestList,
                         starts: torch.Tensor, file_shard: torch.Tensor,
                         data_cap: int, pipeline: bool = False,
                         depth: int | None = None,
                         slow_hop_codec: str | None = None,
                         placement=None,
                         kernel_fusion: str | None = None) -> torch.Tensor:
    """Round loop of the collective read over all ranks.

    r/starts: every rank's requests ``[P, cap]`` and the start of each
    request's payload; file_shard: the file as ``[n_dest, domain_len]``
    in domain order. Returns the payloads ``[P, data_cap]`` (zero past
    each rank's total length).

    Per round the aggregators broadcast one ``cb`` window each and every
    rank gathers the elements of its requests that fall in it. On one
    device the broadcast (the reference's ``all_gather`` over ``node``)
    is the identity: the ``[n_dest, cb]`` windows are computed once for
    all ranks. ``slow_hop_codec`` encodes those windows as rows and
    decodes them, residual-free (a broadcast repeats nothing, so
    ``ef-int8`` is plain per-window quantization here); with
    ``kernel_fusion="fused_round"`` and ``"rle"`` the zero-skip kernels
    do it. ``placement`` permutes which slot serves each domain: slot
    ``perm[g]`` gets domain g's shard (the reference's up-front
    ``ppermute``, here indexing) and ranks index the windows through the
    permutation, so the payloads are the same for every placement. The
    depth-k ring keeps the reference's prologue, steady state and
    epilogue: window t is fetched while the oldest carried window is
    placed.
    """
    n_dest, cb, dl = sched.n_aggregators, sched.cb, sched.domain_len
    dev = file_shard.device
    if not placement_mod.is_identity(placement):
        perm = placement_mod.validate_placement(placement, n_dest)
        inv = placement_mod.inverse_placement(perm)
        file_shard = file_shard[torch.tensor(inv, dtype=torch.int64,
                                             device=dev)]
        slot_of = torch.tensor(perm, dtype=torch.int64, device=dev)
    else:
        slot_of = None
    lengths = r.lengths.to(torch.int64)
    eidx = torch.arange(data_cap, device=dev, dtype=torch.int64)
    req_of = repeat_index(lengths, data_cap)
    # file positions wrap as the reference's int32 sum does
    fpos = wrap_int32(r.offsets.to(torch.int64).gather(-1, req_of)
                      + (eidx - starts.to(torch.int64).gather(-1, req_of)))
    del req_of
    live = eidx < lengths.sum(dim=-1, keepdim=True)
    fpos = torch.where(live, fpos, 0)
    dest, wloc = fpos // dl, fpos % dl
    del fpos
    # out-of-range positions clamp, as the reference's gather does (a
    # negative domain wraps once first, as jnp indexing does)
    slot = (dest if slot_of is None
            else slot_of[torch.where(dest < 0, dest + n_dest, dest)
                         .clamp_(0, n_dest - 1)])
    wround = wloc // cb
    src = wrap_int32(slot.to(torch.int64) * cb + (wloc - wround * cb)
                     ).to(torch.int64)
    del dest, wloc, slot
    src.clamp_(0, n_dest * cb - 1)

    enc, dec, _ = _codec_hooks(slow_hop_codec, file_shard.dtype, (cb,),
                               dev, fused=kernel_fusion == "fused_round")

    def fetch(t):
        with trace.span("repro_torch.fetch"):
            win = file_shard[:, t * cb:(t + 1) * cb].contiguous()
            parts, _ = enc(win, ())             # no residual to carry
            return dec(parts).to(file_shard.dtype).reshape(-1)

    def scatter(t, out, allw):
        trace.count("route_slots", out.numel())
        with trace.span("repro_torch.scatter"):
            active = live & (wround == t)
            return torch.where(active, allw[src], out)

    out = torch.zeros((r.offsets.shape[0], data_cap),
                      dtype=file_shard.dtype, device=dev)
    d = max(1, min(_effective_depth(pipeline, depth), sched.n_rounds))
    ring = [fetch(i) for i in range(d - 1)]          # prologue
    for t in range(d - 1, sched.n_rounds):
        ring.append(fetch(t))                        # broadcast window t …
        out = scatter(t - (d - 1), out, ring.pop(0))  # … place the oldest
    for j, allw in enumerate(ring):                  # epilogue
        out = scatter(sched.n_rounds - (d - 1) + j, out, allw)
    return out


def peak_aggregator_buffer_elems(data_cap: int, n_nodes: int,
                                 ranks_per_node: int, domain_len: int,
                                 cb_buffer_size: int | None,
                                 pipeline: bool = False,
                                 pipeline_depth: int | None = None,
                                 slow_hop_codec: str | None = None) -> dict:
    """Static receive-side buffer sizes (elements) of one aggregator in
    the write paths, as the reference defines them.

    ``single_shot`` is the flattened payload stack after the slow-axis
    exchange plus the intra-node gather — linear in the participating
    rank count. ``rounds`` is the exchanged slice plus one window image,
    times the ring depth for the in-flight windows — independent of
    ``ranks_per_node``. ``tam_stage1_*`` are the local aggregator's
    intra-node gather buffers (bounded at ``min(data_cap, cb)`` per
    rank by the fused round loop). ``slow_hop_codec`` scales the
    in-flight windows by the codec's static wire width.
    """
    wire = (codec_mod.get_codec(slow_hop_codec).jax_wire_overhead
            if slow_hop_codec is not None else 1.0)
    single = n_nodes * ranks_per_node * data_cap + domain_len
    cb = cb_buffer_size if cb_buffer_size is not None else domain_len
    in_flight = _effective_depth(pipeline, pipeline_depth)
    rounds = (math.ceil(n_nodes * min(data_cap, cb) * wire)
              * in_flight + cb + domain_len)
    return {
        "single_shot": single,
        "rounds": rounds,
        "tam_stage1_single_shot": ranks_per_node * data_cap,
        "tam_stage1_rounds": ranks_per_node * min(data_cap, cb),
    }
