"""Host-level collective I/O: the literal TAM reproduction (port of
``repro.checkpoint.host_io``).

Both collective-write schedules over a set of simulated "ranks" placed
on "nodes":

* two-phase: every rank's (offset, length, payload) requests go straight
  to the global aggregator owning the stripe (all-to-many);
* TAM: ranks aggregate to P_L local aggregators inside their node
  (merge-sort + coalesce), then only local aggregators talk to the
  global aggregators.

:class:`HostCollectiveIO` is a thin wrapper over the plan/executor
split: :meth:`HostCollectiveIO.plan_for` compiles the schedule through
the port's planner (``repro_torch.core.plan.compile_plan``, byte
units), and ``checkpoint.host_exec.execute_write`` runs it (or
``checkpoint.mp_exec`` on real worker processes, ``transport="mp"``).
Stage 1, the intra-node aggregation, stays here because it is where
ranks map onto nodes and failed-aggregator fallback lives.

Data movement is real: requests and payloads are tensors on the
writer's device (the card unless the caller asks for the CPU), merged,
coalesced and packed there, and the segment files are byte-identical to
the reference's for both schedules at every ring depth. *Time* is
modeled with the alpha-beta congestion machine of ``core.cost_model``
applied to the actual per-phase message sizes and counts, in the
reference's floating-point order, so every modeled ``IOTimings`` field
equals the reference's.
"""
from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import host_exec
from repro_torch.checkpoint.host_exec import PAIR_BYTES
from repro_torch.core import codec as codec_mod
from repro_torch.core._tensor import cat_views, to_host
from repro_torch.core.cost_model import (Machine, Workload, optimal_cb,
                                         optimal_read_cb, with_codec)
from repro_torch.core.domains import FileLayout
from repro_torch.core.faults import TornWriteError, partial_marker
from repro_torch.core.plan import (IOConfig, IOPlan, compile_plan,
                                   resolve_method, resolve_slow_hop_codec)
from repro_torch.core.session import IOSession  # noqa: F401 (re-export)

# sentinel distinguishing "caller never passed this legacy kwarg" from
# an explicit None (None is a meaningful knob value: codec off,
# placement off, single-shot cb)
_UNSET: object = object()

_KNOB_FIELDS = ("cb_bytes", "pipeline", "pipeline_depth",
                "slow_hop_codec", "placement", "kernel_fusion",
                "transport")


def resolve_knobs(config: IOConfig | None, *, warn: bool = False,
                  stacklevel: int = 3, **legacy) -> dict:
    """The unified knob surface: fold a single :class:`IOConfig` and/or
    per-knob legacy kwargs into concrete knob values.

    ``config=None`` + legacy kwargs is the pre-config calling
    convention — it still works, but ``HostCollectiveIO.write`` and
    ``read`` pass ``warn=True`` so it raises ONE
    :class:`DeprecationWarning` per call site. With a config, explicit
    legacy kwargs act as sparse overrides of the config's fields (no
    warning). Knob names map 1:1 onto IOConfig fields except
    ``cb_bytes`` ↔ ``cb_buffer_size`` (host units are bytes) and the
    pipeline pair: a non-pipelined config yields
    ``pipeline_depth=None`` (the host convention for "serial"), so a
    config round-trips to the identical plan the legacy kwargs built.
    """
    legacy = {k: v for k, v in legacy.items() if v is not _UNSET}
    unknown = set(legacy) - set(_KNOB_FIELDS)
    if unknown:
        raise TypeError(f"unknown knob(s): {sorted(unknown)}")
    if config is None:
        if legacy and warn:
            warnings.warn(
                "per-knob kwargs (cb_bytes / pipeline / pipeline_depth /"
                " slow_hop_codec / placement / kernel_fusion /"
                " transport) are deprecated; pass config=IOConfig(...) —"
                " legacy kwargs on top of a config act as sparse"
                " overrides",
                DeprecationWarning, stacklevel=stacklevel)
        out = dict(cb_bytes=None, pipeline=False, pipeline_depth=None,
                   slow_hop_codec=None, placement=None,
                   kernel_fusion=None, transport=None)
    else:
        out = dict(
            cb_bytes=config.cb_buffer_size,
            pipeline=config.pipeline,
            pipeline_depth=(config.pipeline_depth if config.pipeline
                            else None),
            slow_hop_codec=config.slow_hop_codec,
            placement=config.placement,
            kernel_fusion=config.kernel_fusion,
            transport=getattr(config, "transport", None))
    out.update(legacy)
    return out


@dataclass
class IOTimings:
    intra_comm: float = 0.0
    intra_sort: float = 0.0
    intra_memcpy: float = 0.0
    inter_comm: float = 0.0
    inter_sort: float = 0.0
    io: float = 0.0
    messages_at_ga: int = 0        # max receives at one GA (per round)
    requests_before: int = 0
    requests_after: int = 0
    rounds_executed: int = 1       # exchange rounds (1 == single shot)
    pipeline_depth: int = 1        # executed in-flight windows (1=serial)
    overlap_saved: float = 0.0     # time hidden by the pipelined drain:
    # the depth-k ring's makespan (cost_model.pipeline_span over the
    # measured per-round arrays) replaces the serial comm+io sum, so
    # total == serial total - overlap_saved
    overlap_fraction: float = 0.0  # overlap_saved / the hideable time
    # (the smaller of steady-state comm and io); 0 when serial or when
    # there is no steady state (single round)
    slow_hop_codec: str | None = None  # executed wire codec (None = off)
    slow_hop_raw_bytes: int = 0    # payload bytes offered to the codec
    slow_hop_wire_bytes: int = 0   # payload bytes after encoding (what
    # the per-round incast beta actually charged)
    codec: float = 0.0             # encode+decode scan time (codec_bw)
    placement: tuple | None = None  # executed aggregator placement
    # (plan.placement; None = placement-off legacy accounting)
    slow_hop_fast_bytes: int = 0   # slow-hop bytes that stayed on the
    # serving aggregator's node under the placement (charged intra)
    slow_hop_slow_bytes: int = 0   # slow-hop bytes that crossed nodes
    node_bytes: tuple = ()         # measured per-(domain, sender-node)
    # payload matrix — what a session feeds resolve_placement("auto")
    comm_rounds: tuple = ()        # measured per-round exchange times
    io_rounds: tuple = ()          # measured per-round drain times
    plan_seconds: float = 0.0      # REAL wall-clock planning time (the
    # cost a session amortizes; every other field is modeled seconds)
    plan_source: str = "compiled"  # "compiled" | "session-hit" |
    # "session-trial" (a measured-feedback replan being tried out)
    node_slowdown: tuple = ()      # measured per-node service slowdown
    # (seconds-per-byte served, normalized by the fastest busy node;
    # 1.0 = healthy) — the straggler signal placement="auto" and the
    # session's evacuation map consume (core.faults)
    serve_map: tuple | None = None  # executed degraded serve map
    # (domain -> serving slot, possibly non-bijective; None = the
    # plan's bijective placement served every domain)
    retries: int = 0               # lost slow-hop messages re-sent
    # (bounded by FaultSpec.max_retries; each charged timeout+backoff)
    recovery_seconds: float = 0.0  # total fault-recovery time: dead-
    # aggregator detection + round replay + torn-segment rewrites —
    # reported separately, and added to .total (recovery is real time)
    repair_map: tuple | None = None  # post-repair serve map after a
    # dead aggregator (None = no repair happened)
    torn_writes_detected: int = 0  # partial-write markers detected and
    # repaired by rewrite (drain faults + dead-aggregator tears)
    transport: str | None = None   # which byte-moving backend produced
    # this measurement ("mp" = real processes + wall-clock rounds;
    # None = in-process executor, modeled time) — sessions key on it so
    # feedback never crosses executors
    direction: str = "write"       # which executor filled this
    node_cache: bool | None = None  # read path: node-level window cache
    # on/off (None = a write; the knob does not exist there)
    cache_hits: int = 0            # read deliveries served from a node's
    # window cache (co-located readers after the elected fetch)
    cache_misses: int = 0          # window fetches that left the serving
    # aggregator: one per (window, node) with the cache on, one per
    # (window, rank) without — the q-fold duplication the cache deletes
    read_bytes: int = 0            # bytes read from disk, once per
    # needed window (the subset-restore economy measure)
    snapshot_seconds: float = 0.0  # REAL wall time an async save spent
    # copying the tree to host buffers (the checkpoint layer's)
    drain_wall_seconds: float = 0.0  # REAL wall time of the async
    # background drain; 0 on sync writes
    overlap_hidden_seconds: float = 0.0  # the part of the async drain
    # that ran before the caller first blocked on it

    @property
    def hidden_fraction(self) -> float:
        """Fraction of the async drain's wall time hidden behind the
        caller's compute (0.0 = sync write, or the caller blocked
        immediately; 1.0 = the drain finished before anyone waited)."""
        if self.drain_wall_seconds <= 0.0:
            return 0.0
        return self.overlap_hidden_seconds / self.drain_wall_seconds

    @property
    def cache_hit_ratio(self) -> float:
        """Fraction of read deliveries served intra-node from a window
        cache (0.0 = every delivery paid a fetch; a write reports 0)."""
        return self.cache_hits / max(self.cache_hits
                                     + self.cache_misses, 1)

    @property
    def comm(self) -> float:
        return self.intra_comm + self.inter_comm

    @property
    def total(self) -> float:
        return (self.intra_comm + self.intra_sort + self.intra_memcpy
                + self.inter_comm + self.inter_sort + self.io
                + self.codec - self.overlap_saved
                + self.recovery_seconds)

    @property
    def coalesce_ratio(self) -> float:
        return self.requests_after / max(self.requests_before, 1)

    @property
    def slow_hop_compression_ratio(self) -> float:
        """Achieved raw/wire ratio on the slow hop (1.0 = codec off or
        nothing moved; > 1 means the wire moved fewer bytes)."""
        if self.slow_hop_wire_bytes <= 0:
            return 1.0
        return self.slow_hop_raw_bytes / self.slow_hop_wire_bytes


def _zero_fraction(payloads) -> float:
    """Fraction of zero bytes across the payloads (numpy or tensors):
    ``codec.zero_fraction``'s statistic, counted where the bytes are."""
    arrs = list(payloads)
    if arrs and all(isinstance(d, torch.Tensor) for d in arrs):
        total = sum(int(d.numel()) for d in arrs)
        if not total:
            return 0.0
        zeros = int(torch.stack([(d == 0).sum() for d in arrs]).sum())
        return zeros / total
    return codec_mod.zero_fraction(to_host(d, np.uint8) for d in arrs)


def _fingerprint(payloads) -> int:
    """The session key's sampled payload fingerprint: an O(ranks)
    strided probe of zero-ness + content, so same-shape payloads with a
    different sparsity land in different entries."""
    fp = 0
    for dd in payloads:
        n = int(dd.numel()) if isinstance(dd, torch.Tensor) else dd.size
        if n:
            probe = to_host(dd[::max(1, n // 16)][:17], np.uint8)
            fp = (fp * 1000003
                  + int((probe == 0).sum()) * 8191
                  + int(probe.astype(np.int64).sum())) \
                & 0xFFFFFFFFFFFF
    return fp


def split_stripes(offs: torch.Tensor, lens: torch.Tensor,
                  owner: torch.Tensor, stripe_size: int):
    """Split int64 requests at stripe boundaries (ROMIO file-domain
    split), every request's pieces in order: ``(offsets, lengths,
    owner)`` of the pieces. Zero-length requests vanish; the payload
    order is unchanged."""
    first = offs // stripe_size
    n = torch.where(lens > 0, (offs + lens - 1) // stripe_size - first + 1,
                    0)
    idx = torch.repeat_interleave(torch.arange(offs.numel(),
                                               device=offs.device), n)
    j = torch.arange(idx.numel(), device=offs.device) \
        - (torch.cumsum(n, 0) - n)[idx]
    lo = torch.maximum(offs[idx], (first[idx] + j) * stripe_size)
    hi = torch.minimum(offs[idx] + lens[idx],
                       (first[idx] + j + 1) * stripe_size)
    return lo, hi - lo, owner[idx]


def _per_owner(offs, lens, owner, data, n_owners: int):
    """Per-owner ``(offsets, lengths, payload)`` views of a request
    stream sorted by owner, its payload packed in request order."""
    counts = torch.bincount(owner, minlength=n_owners)
    nbytes = torch.zeros(n_owners, dtype=torch.int64,
                         device=offs.device).index_add_(0, owner, lens)
    counts, nbytes = counts.tolist(), nbytes.tolist()
    return list(zip(torch.split(offs, counts), torch.split(lens, counts),
                    torch.split(data, nbytes)))


class HostCollectiveIO:
    """Collective write/read over simulated ranks -> striped file segments.

    ranks are grouped into ``n_nodes`` nodes; ``stripe_count`` global
    aggregators each own stripes ``s % stripe_count`` and write one file
    segment (``<path>.seg<g>``). ``device``: where requests and payloads
    move — the card unless the caller passes ``device="cpu"``; without
    a card the default raises.
    """

    def __init__(self, n_ranks: int, n_nodes: int, stripe_size: int,
                 stripe_count: int, machine: Machine | None = None,
                 session: "IOSession | None" = None, device=None):
        assert n_ranks % n_nodes == 0
        self.device = resolve_device(device)
        self.n_ranks, self.n_nodes = n_ranks, n_nodes
        self.stripe_size, self.stripe_count = stripe_size, stripe_count
        self.machine = machine or Machine()
        # cross-write plan cache + measured-feedback tuner; every write
        # may also pass its own (write(session=...) overrides)
        self.session = session

    # ------------------------------------------------------------------
    def _measured_workload(self, rank_requests, pipeline: bool = True,
                           slow_hop_codec: str | None = None) -> Workload:
        """Cost-model Workload for THIS request set (byte units). With a
        codec requested (a name, or ``"auto"``, which weighs the lossless
        byte codec), ``slow_hop_ratio`` is ESTIMATED from the payload's
        measured zero fraction through that codec's model; with none,
        the O(total_bytes) zero scan is skipped and the ratio stays
        1.0."""
        P = self.n_ranks
        total = float(sum(int(to_host(ln, np.int64).sum())
                          for _, ln, _ in rank_requests))
        n_req = float(sum(to_host(o, np.int64).size
                          for o, _, _ in rank_requests))
        ratio = 1.0
        if slow_hop_codec is not None:
            name = "rle" if slow_hop_codec == "auto" else slow_hop_codec
            zf = _zero_fraction(d for _, _, d in rank_requests)
            ratio = codec_mod.get_codec(name).modeled_ratio(zf, total)
        return Workload(P=P, nodes=self.n_nodes, P_G=self.stripe_count,
                        k=max(n_req, 1.0) / P, total_bytes=max(total, 1.0),
                        stripe_size=float(self.stripe_size),
                        overlap=1.0 if pipeline else 0.0,
                        slow_hop_ratio=ratio)

    def _ratio_codec(self, method, cb_bytes, pipeline_depth,
                     slow_hop_codec):
        """Which codec (if any) the measured-ratio zero scan should
        model: the codec's own ``"auto"`` resolution, or a named codec
        whose discount must feed another auto knob."""
        any_auto = (method == "auto" or cb_bytes == "auto"
                    or pipeline_depth == "auto")
        return (slow_hop_codec
                if slow_hop_codec == "auto"
                or (slow_hop_codec is not None and any_auto)
                else None)

    @staticmethod
    def _extent(rank_requests, default: int = 0) -> int:
        """Last written byte of a request set (the layout fingerprint:
        the session key, the cb candidate sweep and the plan's file_len
        padding share it)."""
        ends = [int((to_host(o, np.int64) + to_host(ln, np.int64)).max())
                for o, ln, _ in rank_requests if len(o)]
        return max(ends, default=default)

    def _cb_candidates(self, rank_requests) -> tuple[int, ...]:
        """Stripe-aligned cb candidates for THIS request set's extent
        (what ``auto_cb_bytes`` sweeps)."""
        ext = self._extent(rank_requests, self.stripe_size)
        n_str = -(-ext // self.stripe_size)
        dom_bytes = -(-n_str // self.stripe_count) * self.stripe_size
        cands, c = [], self.stripe_size
        while c < dom_bytes:
            cands.append(c)
            c *= 2
        cands.append(dom_bytes)
        return tuple(cands)

    def workload_for(self, rank_requests, *, method: str = "twophase",
                     cb_bytes=None, pipeline: bool = False,
                     pipeline_depth=None,
                     slow_hop_codec: str | None = None) -> Workload:
        """The measured workload a write with these knobs would resolve
        its autos against (what a session stores alongside the plan)."""
        pipe = pipeline or pipeline_depth is not None
        return self._measured_workload(
            rank_requests, pipe,
            self._ratio_codec(method, cb_bytes, pipeline_depth,
                              slow_hop_codec))

    # ------------------------------------------------------------------
    def plan_for(self, *, method: str = "twophase",
                 cb_bytes: int | str | None = _UNSET,
                 pipeline: bool = _UNSET,
                 pipeline_depth: int | str | None = _UNSET,
                 file_len: int | None = None, rank_requests=None,
                 local_aggregators: int | None = None,
                 req_cap: int = _UNSET, data_cap: int = _UNSET,
                 coalesce_cap: int | None = _UNSET,
                 slow_hop_codec: str | None = _UNSET,
                 placement=_UNSET, workload: Workload | None = None,
                 config: IOConfig | None = None,
                 kernel_fusion: str | None = _UNSET,
                 transport: str | None = _UNSET,
                 direction: str = "write") -> IOPlan:
        """Compile this writer's schedule (bytes) — the host side of the
        plan-identity contract, and THE auto-resolution point of the
        host path: method resolves first (measured workload), then
        ``cb_bytes="auto"`` tunes for that method at the
        ``local_aggregators`` P_L the write will use. ``file_len``
        defaults to the request set's extent padded so every aggregator
        domain is a whole number of cb windows. ``config`` is the
        unified knob surface (:func:`resolve_knobs`); explicit per-knob
        kwargs are sparse overrides. ``direction="read"`` compiles a
        restore schedule through the same passes.
        """
        k = resolve_knobs(config, cb_bytes=cb_bytes, pipeline=pipeline,
                          pipeline_depth=pipeline_depth,
                          slow_hop_codec=slow_hop_codec,
                          placement=placement, kernel_fusion=kernel_fusion,
                          transport=transport)
        cb_bytes, pipeline = k["cb_bytes"], k["pipeline"]
        pipeline_depth = k["pipeline_depth"]
        slow_hop_codec, placement = k["slow_hop_codec"], k["placement"]
        kernel_fusion = k["kernel_fusion"]
        transport = k["transport"]
        if config is not None:
            caps = (config.req_cap, config.data_cap, config.coalesce_cap)
        else:
            caps = (0, 0, None)
        req_cap = caps[0] if req_cap is _UNSET else req_cap
        data_cap = caps[1] if data_cap is _UNSET else data_cap
        coalesce_cap = caps[2] if coalesce_cap is _UNSET else coalesce_cap
        pipe = pipeline or pipeline_depth is not None
        if workload is None and rank_requests is not None:
            workload = self._measured_workload(
                rank_requests, pipe,
                self._ratio_codec(method, cb_bytes, pipeline_depth,
                                  slow_hop_codec))
        # codec resolves before any other auto: its beta discount /
        # encode cost must be visible to the method and cb tuners, and
        # a codec-off plan must not keep the measured ratio estimate
        if workload is not None:
            if slow_hop_codec == "auto":
                slow_hop_codec = resolve_slow_hop_codec(workload,
                                                        self.machine)
            if slow_hop_codec is None and workload.slow_hop_ratio != 1.0:
                workload = with_codec(workload, 1.0)
        if method == "auto" and workload is not None:
            method = resolve_method(workload, self.machine)
        if cb_bytes == "auto":
            if rank_requests is None:
                raise ValueError(
                    'cb_bytes="auto" needs rank_requests to measure')
            cb_bytes = self.auto_cb_bytes(
                rank_requests, method=method,
                local_aggregators=local_aggregators, pipeline=pipe,
                workload=workload, direction=direction)
        if cb_bytes is not None and cb_bytes % self.stripe_size \
                and self.stripe_size % cb_bytes:
            # whole-stripe multiples or exact sub-stripe divisors
            raise ValueError("cb_bytes must align with stripe_size")
        if file_len is None:
            ext = self.stripe_size
            if rank_requests is not None:
                ext = self._extent(rank_requests, self.stripe_size)
            n_str = -(-ext // self.stripe_size)
            dom = -(-n_str // self.stripe_count) * self.stripe_size
            if cb_bytes is not None:       # whole number of windows
                dom = -(-dom // cb_bytes) * cb_bytes
            file_len = dom * self.stripe_count
        cfg = IOConfig(
            req_cap=req_cap, data_cap=data_cap, coalesce_cap=coalesce_cap,
            cb_buffer_size=cb_bytes, pipeline=pipe,
            pipeline_depth=(pipeline_depth if pipeline_depth is not None
                            else 2),
            slow_hop_codec=slow_hop_codec,
            placement=(tuple(placement)
                       if isinstance(placement, (list, tuple))
                       else placement),
            kernel_fusion=kernel_fusion, transport=transport)
        return compile_plan(
            FileLayout(stripe_size=self.stripe_size,
                       stripe_count=self.stripe_count, file_len=file_len),
            cfg, n_aggregators=self.stripe_count, n_nodes=self.n_nodes,
            n_ranks=self.n_ranks, method=method, direction=direction,
            machine=self.machine, workload=workload, unit_bytes=1)

    # ------------------------------------------------------------------
    def _session_plan(self, session, skey, rank_requests, *, pipeline,
                      local_aggregators, kernel_fusion, transport,
                      direction):
        """The session protocol's begin step: ``(plan, source,
        serve_map)`` of a hit or a trial, or ``(None, "compiled",
        None)`` on a miss."""
        begin = session.begin_read if direction == "read" \
            else session.begin_write
        kind, payload = begin(skey, machine=self.machine)
        if kind == "hit":
            plan, serve_map = payload
            return plan, "session-hit", serve_map
        if kind == "trial":
            kw = {} if direction == "read" else dict(
                local_aggregators=local_aggregators)
            plan = self.plan_for(
                method=payload["method"], cb_bytes=payload["cb_bytes"],
                pipeline=pipeline or payload["pipeline_depth"] > 1,
                pipeline_depth=payload["pipeline_depth"],
                rank_requests=rank_requests,
                slow_hop_codec=payload["slow_hop_codec"],
                placement=payload["placement"],
                kernel_fusion=kernel_fusion, transport=transport,
                direction=direction, **kw)
            serve_map = payload.get("serve_map")
            session.register_trial(skey, plan, serve_map)
            return plan, "session-trial", serve_map
        return None, "compiled", None

    def _upload(self, rank_requests):
        """The request set as one stream on the writer's device:
        ``(offsets, lengths, rank, payload)``, the payload packed in
        rank then request order (each rank's bytes past its requests'
        are not sent)."""
        offs = [to_host(o, np.int64) for o, _, _ in rank_requests]
        lens = [to_host(ln, np.int64) for _, ln, _ in rank_requests]
        used = [int(ln.sum()) for ln in lens]
        counts = [o.size for o in offs]
        dev = self.device
        pays = [d for _, _, d in rank_requests]
        if pays and all(isinstance(d, torch.Tensor) for d in pays):
            data = cat_views([d.reshape(-1)[:n].to(dev)
                              for d, n in zip(pays, used)], dev)
        else:
            data = torch.from_numpy(np.concatenate(
                [to_host(d, np.uint8).reshape(-1)[:n]
                 for d, n in zip(pays, used)]
                + [np.zeros(0, np.uint8)])).to(dev)
        as_t = lambda a: torch.from_numpy(np.concatenate(  # noqa: E731
            a + [np.zeros(0, np.int64)])).to(dev)
        rank = torch.repeat_interleave(
            torch.arange(len(rank_requests), device=dev),
            torch.tensor(counts, dtype=torch.int64, device=dev))
        return as_t(offs), as_t(lens), rank, data

    # ------------------------------------------------------------------
    def write(self, rank_requests, path: str, method: str = "tam",
              local_aggregators: int | None = None,
              failed_aggregators: set[int] | None = None,
              cb_bytes: int | str | None = _UNSET,
              pipeline: bool = _UNSET,
              pipeline_depth: int | str | None = _UNSET,
              slow_hop_codec: str | None = _UNSET,
              placement=_UNSET,
              session: "IOSession | None" = None,
              config: IOConfig | None = None,
              kernel_fusion: str | None = _UNSET,
              transport: str | None = _UNSET,
              faults=None, heartbeat=None) -> IOTimings:
        """rank_requests: list of ``(offsets int64, lengths int64,
        payload uint8)`` per rank in bytes (numpy arrays or tensors).
        method: "tam" | "twophase" | "auto". Returns :class:`IOTimings`;
        writes ``<path>.seg<g>`` files.

        The knobs are the reference's, with its semantics:
        ``failed_aggregators`` (a failed local aggregator's group falls
        back to its next healthy member), ``cb_bytes`` (None = single
        shot, ``"auto"``), ``pipeline``/``pipeline_depth`` (the depth-k
        window ring, ``"auto"``), ``slow_hop_codec`` (lossless byte
        codecs only), ``placement``, ``session`` (plan reuse and
        measured feedback), ``config`` (one :class:`IOConfig`; per-knob
        kwargs without it are deprecated), ``kernel_fusion`` (a plan
        field; the host executor builds its images with the ``pack``
        kernel either way), ``transport`` (``"mp"``: real worker
        processes, ``checkpoint.mp_exec``) and ``faults``/``heartbeat``
        (``core.faults.FaultSpec`` and the failure detector, threaded to
        the executor, never into the plan or the session key). A write
        that raises mid-trial reverts its session trial.
        """
        knobs = resolve_knobs(config, warn=True, cb_bytes=cb_bytes,
                              pipeline=pipeline,
                              pipeline_depth=pipeline_depth,
                              slow_hop_codec=slow_hop_codec,
                              placement=placement,
                              kernel_fusion=kernel_fusion,
                              transport=transport)
        cb_bytes, pipeline = knobs["cb_bytes"], knobs["pipeline"]
        pipeline_depth = knobs["pipeline_depth"]
        slow_hop_codec = knobs["slow_hop_codec"]
        placement = knobs["placement"]
        kernel_fusion = knobs["kernel_fusion"]
        transport = knobs["transport"]
        failed_aggregators = failed_aggregators or set()
        plan_t0 = time.perf_counter()
        session = session if session is not None else self.session
        plan, source, skey, serve_map = None, "compiled", None, None
        if session is not None:
            extent = self._extent(rank_requests)
            total = sum(int(to_host(ln, np.int64).sum())
                        for _, ln, _ in rank_requests)
            n_req = sum(int(to_host(o, np.int64).size)
                        for o, _, _ in rank_requests)
            fp = _fingerprint(d for _, _, d in rank_requests)
            # the Machine is part of the key: writers with different
            # calibrations never share an entry
            skey = (self.n_ranks, self.n_nodes, self.stripe_size,
                    self.stripe_count, self.machine, extent, total,
                    n_req, fp, method,
                    cb_bytes, pipeline, pipeline_depth, slow_hop_codec,
                    tuple(placement) if isinstance(placement,
                                                   (list, tuple))
                    else placement, local_aggregators, kernel_fusion,
                    transport)
            plan, source, serve_map = self._session_plan(
                session, skey, rank_requests, pipeline=pipeline,
                local_aggregators=local_aggregators,
                kernel_fusion=kernel_fusion, transport=transport,
                direction="write")
        if plan is None:
            workload = (self.workload_for(
                rank_requests, method=method, cb_bytes=cb_bytes,
                pipeline=pipeline, pipeline_depth=pipeline_depth,
                slow_hop_codec=slow_hop_codec)
                if session is not None else None)
            plan = self.plan_for(
                method=method, cb_bytes=cb_bytes, pipeline=pipeline,
                pipeline_depth=(2 if pipeline_depth == "auto"
                                else pipeline_depth),
                rank_requests=rank_requests,
                local_aggregators=local_aggregators,
                slow_hop_codec=slow_hop_codec, placement=placement,
                kernel_fusion=kernel_fusion, transport=transport,
                workload=workload)
            if session is not None:
                session.register(
                    skey, plan,
                    requested={"method": method, "cb_bytes": cb_bytes,
                               "pipeline_depth": pipeline_depth,
                               "slow_hop_codec": slow_hop_codec,
                               "placement": placement},
                    workload=workload,
                    cb_candidates=(self._cb_candidates(rank_requests)
                                   if cb_bytes == "auto" else ()),
                    P_L=((local_aggregators or self.n_nodes * 4)
                         if plan.method == "tam" else None),
                    n_nodes=self.n_nodes,
                    n_aggregators=self.stripe_count)
        self._require_lossless(plan, "write")
        m = self.machine
        t = IOTimings()
        t.plan_seconds = time.perf_counter() - plan_t0
        t.plan_source = source
        P, nodes = self.n_ranks, self.n_nodes
        q = P // nodes
        offs, lens, rank, data = self._upload(rank_requests)
        s_off, s_len, s_rank = split_stripes(offs, lens, rank,
                                             self.stripe_size)
        t.requests_before = int(s_off.numel())
        # node-level faults, degraded serve maps and the mp transport
        # (arenas group senders by node) need the sender->node map
        want_nodes = (plan.placement is not None or faults is not None
                      or serve_map is not None
                      or plan.transport is not None)
        sender_nodes = None

        # ---- stage 1: intra-node aggregation (plan.method) -----------
        if plan.method == "twophase":
            per_la = _per_owner(s_off, s_len, s_rank, data, P)
            if want_nodes:
                sender_nodes = [r // q for r in range(P)]
        else:
            P_L = local_aggregators or nodes * 4
            assert P_L % nodes == 0
            c = P_L // nodes                # local aggs per node
            groups = [g for node in range(nodes) for g in np.array_split(
                np.arange(node * q, (node + 1) * q), c)]
            la_of = np.zeros(P, np.int64)
            for i, g in enumerate(groups):
                la_of[g] = i
            la = torch.from_numpy(la_of).to(self.device)[s_rank]
            c_off, c_len, packed, c_la, n_req = \
                host_exec.merge_coalesce_groups(s_off, s_len, data, la,
                                                len(groups))
            # coalescing may fuse runs ACROSS stripe boundaries; re-split
            # so each request has exactly one owner
            c_off, c_len, c_la = split_stripes(c_off, c_len, c_la,
                                               self.stripe_size)
            per_la = _per_owner(c_off, c_len, c_la, packed, len(groups))
            rank_bytes = torch.zeros(P, dtype=torch.int64,
                                     device=self.device) \
                .index_add_(0, s_rank, s_len + PAIR_BYTES).cpu().numpy()
            if want_nodes:
                sender_nodes = [i // c for i in range(len(groups))]
            for i, g in enumerate(groups):
                node = i // c
                # an injected straggler aggregates slower inside its
                # node too
                nf = faults.slowdown(node) if faults is not None else 1.0
                # backup-aggregator selection: default LA = first rank
                # of the group (paper's policy); skip failed ones
                if len(g) and all(int(r) in failed_aggregators for r in g):
                    raise RuntimeError(
                        f"no healthy aggregator in group {list(g)}")
                reassigned = bool(len(g)) and \
                    int(g[0]) in failed_aggregators
                n_cmp = host_exec.n_comparisons(int(n_req[i]), len(g))
                # intra-node timing: many-to-one receives + sort + copy
                bytes_in = sum(int(rank_bytes[r]) for r in g)
                reassign_penalty = m.alpha_intra if reassigned else 0.0
                t.intra_comm = max(
                    t.intra_comm,
                    nf * (m.alpha_intra * len(g)
                          + m.beta_intra * bytes_in
                          + reassign_penalty))
                t.intra_sort = max(t.intra_sort,
                                   nf * m.sort_per_cmp * n_cmp)
                t.intra_memcpy = max(t.intra_memcpy,
                                     nf * bytes_in / m.memcpy_bw)
        t.requests_after = sum(int(la[0].numel()) for la in per_la)

        # ---- inter-node exchange + I/O: the chosen executor ----------
        if plan.transport == "mp":
            from repro_torch.checkpoint import mp_exec
            exec_write = mp_exec.execute_write
        else:
            exec_write = host_exec.execute_write
        try:
            t = exec_write(
                plan, m, per_la, path, t,
                depth_request="auto" if pipeline_depth == "auto" else None,
                sender_nodes=sender_nodes, n_nodes=nodes,
                faults=faults, heartbeat=heartbeat, serve_map=serve_map)
        except BaseException:
            # a write that dies mid-trial must not poison the session
            if session is not None:
                session.abort(skey, plan)
            raise
        if session is not None:
            session.observe(skey, plan, t, serve_map=serve_map)
        return t

    @staticmethod
    def _require_lossless(plan, direction: str) -> None:
        if plan.slow_hop_codec is not None and \
                not codec_mod.get_codec(plan.slow_hop_codec).lossless:
            raise ValueError(
                f"slow_hop_codec={plan.slow_hop_codec!r} is lossy; the "
                f"host {direction} path moves raw bytes — use a lossless "
                f"codec ({codec_mod.lossless_codecs()})")

    # ------------------------------------------------------------------
    def auto_cb_bytes(self, rank_requests, method: str = "tam",
                      local_aggregators: int | None = None,
                      pipeline: bool = True, workload=None,
                      direction: str = "write") -> int:
        """Autotuned collective-buffer size for THIS request set: the
        stripe-aligned cb minimizing ``cost_model.optimal_cb``'s modeled
        total (``optimal_read_cb`` for ``direction="read"``)."""
        cands = self._cb_candidates(rank_requests)
        w = workload if workload is not None else \
            self._measured_workload(rank_requests, pipeline)
        if direction == "read":
            cb, _ = optimal_read_cb(w, self.machine, candidates=cands)
            return cb
        P_L = ((local_aggregators or self.n_nodes * 4)
               if method == "tam" else None)
        cb, _ = optimal_cb(w, self.machine, P_L=P_L, candidates=cands)
        return cb

    # ------------------------------------------------------------------
    def read_file(self, path: str, file_len: int, *, offset: int = 0,
                  nbytes: int | None = None) -> torch.Tensor:
        """Reassemble bytes ``[offset, offset + nbytes)`` of the file
        byte-space from the striped segments (defaults: the whole file)
        as a uint8 tensor on the writer's device. The range maps to
        RANGED per-segment reads — only the stripes it touches are read.
        A touched segment carrying a ``.partial`` marker is a torn write:
        :class:`~repro_torch.core.faults.TornWriteError`."""
        nbytes = file_len - offset if nbytes is None else nbytes
        end = min(offset + nbytes, file_len)
        out = np.zeros(max(end - offset, 0), np.uint8)
        handles: dict = {}
        sizes: dict = {}
        try:
            # file stripe s lives at seg (s % SC), stripe (s // SC)
            for s in (range(offset // self.stripe_size,
                            (end - 1) // self.stripe_size + 1)
                      if out.size else ()):
                g, r = s % self.stripe_count, s // self.stripe_count
                if g not in handles:
                    seg_path = f"{path}.seg{g}"
                    if os.path.exists(partial_marker(seg_path)):
                        raise TornWriteError(seg_path, -1, -1)
                    sizes[g] = os.path.getsize(seg_path)
                    handles[g] = open(seg_path, "rb")
                fo = s * self.stripe_size
                lo, hi = max(offset, fo), min(end, fo + self.stripe_size)
                seg_off = r * self.stripe_size + (lo - fo)
                take = min(hi - lo, max(sizes[g] - seg_off, 0))
                if take > 0:
                    handles[g].seek(seg_off)
                    out[lo - offset:lo - offset + take] = np.frombuffer(
                        handles[g].read(take), np.uint8)
        finally:
            for f in handles.values():
                f.close()
        return torch.from_numpy(out).to(self.device)

    # ------------------------------------------------------------------
    def read(self, rank_requests, path: str, method: str = "twophase",
             cb_bytes: int | str | None = _UNSET,
             pipeline: bool = _UNSET,
             pipeline_depth: int | str | None = _UNSET,
             slow_hop_codec: str | None = _UNSET,
             placement=_UNSET,
             session: "IOSession | None" = None,
             config: IOConfig | None = None,
             kernel_fusion: str | None = _UNSET,
             transport: str | None = _UNSET,
             node_cache: bool = True, fingerprint=None,
             faults=None) -> tuple[list[torch.Tensor], IOTimings]:
        """Collective READ through the full planner — the write's mirror
        and the paper's intra-node aggregation applied to restore.
        rank_requests: list of ``(offsets, lengths)`` per READER rank
        (bytes). Returns ``(payloads, timings)``: one uint8 tensor per
        rank on the writer's device, in request order, and an
        :class:`IOTimings` with ``direction="read"``. The knobs, the
        session protocol (keyed on the reader shape, ``fingerprint``
        and ``node_cache``) and ``node_cache`` itself (one fetch per
        (window, node) and an intra-node fan-out, or every rank fetching
        for itself) are the reference's.
        """
        knobs = resolve_knobs(config, warn=True, cb_bytes=cb_bytes,
                              pipeline=pipeline,
                              pipeline_depth=pipeline_depth,
                              slow_hop_codec=slow_hop_codec,
                              placement=placement,
                              kernel_fusion=kernel_fusion,
                              transport=transport)
        cb_bytes, pipeline = knobs["cb_bytes"], knobs["pipeline"]
        pipeline_depth = knobs["pipeline_depth"]
        slow_hop_codec = knobs["slow_hop_codec"]
        placement = knobs["placement"]
        kernel_fusion = knobs["kernel_fusion"]
        transport = knobs["transport"]
        # reads carry no payload; the planner-facing triples get empty
        # ones (extent/workload measurement are offset/length-only)
        triples = [(to_host(o, np.int64), to_host(ln, np.int64),
                    np.zeros(0, np.uint8)) for o, ln in rank_requests]
        plan_t0 = time.perf_counter()
        session = session if session is not None else self.session
        plan, source, skey, serve_map = None, "compiled", None, None
        if session is not None:
            extent = self._extent(triples)
            total = sum(int(ln.sum()) for _, ln, _ in triples)
            n_req = sum(int(o.size) for o, _, _ in triples)
            skey = ("read", node_cache, fingerprint, self.n_ranks,
                    self.n_nodes, self.stripe_size, self.stripe_count,
                    self.machine, extent, total, n_req, method,
                    cb_bytes, pipeline, pipeline_depth, slow_hop_codec,
                    tuple(placement) if isinstance(placement,
                                                   (list, tuple))
                    else placement, kernel_fusion, transport)
            plan, source, serve_map = self._session_plan(
                session, skey, triples, pipeline=pipeline,
                local_aggregators=None, kernel_fusion=kernel_fusion,
                transport=transport, direction="read")
        if plan is None:
            workload = (self._measured_workload(
                triples, pipeline or pipeline_depth is not None, None)
                if session is not None else None)
            plan = self.plan_for(
                method=method, cb_bytes=cb_bytes, pipeline=pipeline,
                pipeline_depth=(2 if pipeline_depth == "auto"
                                else pipeline_depth),
                rank_requests=triples, slow_hop_codec=slow_hop_codec,
                placement=placement, kernel_fusion=kernel_fusion,
                transport=transport, workload=workload,
                direction="read")
            if session is not None:
                session.register(
                    skey, plan,
                    requested={"method": method, "cb_bytes": cb_bytes,
                               "pipeline_depth": pipeline_depth,
                               "slow_hop_codec": slow_hop_codec,
                               "placement": placement},
                    workload=workload,
                    cb_candidates=(self._cb_candidates(triples)
                                   if cb_bytes == "auto" else ()),
                    P_L=None, n_nodes=self.n_nodes,
                    n_aggregators=self.stripe_count)
        self._require_lossless(plan, "read")
        t = IOTimings()
        t.direction = "read"
        t.node_cache = node_cache
        t.plan_seconds = time.perf_counter() - plan_t0
        t.plan_source = source
        counts = [o.size for o, _, _ in triples]
        rank = torch.repeat_interleave(torch.arange(len(triples)),
                                       torch.tensor(counts,
                                                    dtype=torch.int64))
        cat = lambda i: torch.from_numpy(np.concatenate(  # noqa: E731
            [x[i] for x in triples] + [np.zeros(0, np.int64)]))
        s_off, s_len, s_rank = split_stripes(cat(0), cat(1), rank,
                                             self.stripe_size)
        n_split = torch.bincount(s_rank, minlength=len(triples)).tolist()
        split = list(zip(torch.split(s_off, n_split),
                         torch.split(s_len, n_split)))
        t.requests_before = sum(counts)
        t.requests_after = int(s_off.numel())
        if plan.transport == "mp":
            from repro_torch.checkpoint import mp_exec
            exec_read = mp_exec.execute_read
        else:
            exec_read = host_exec.execute_read
        try:
            outs = exec_read(
                plan, self.machine, split, path, t,
                n_nodes=self.n_nodes,
                ranks_per_node=self.n_ranks // self.n_nodes,
                depth_request=("auto" if pipeline_depth == "auto"
                               else None),
                node_cache=node_cache, serve_map=serve_map,
                faults=faults, device=self.device)
        except BaseException:
            if session is not None:
                session.abort(skey, plan)
            raise
        if session is not None:
            session.observe(skey, plan, t, serve_map=serve_map)
        return outs, t
