"""Fault injection + degraded-mode recovery for the host executor
(port of ``repro.core.faults``).

Everything so far assumed a healthy, static machine; at the paper's
scale (16384 ranks) stragglers and node loss are the steady state, and
a single slow node silently poisons every ``"auto"`` knob the planner
and :class:`~repro_torch.core.session.IOSession` resolve. This module makes
faults an explicit, composable INPUT (:class:`FaultSpec`, threaded
through ``HostCollectiveIO.write`` into
``checkpoint.host_exec.execute_write``) and hosts the recovery policy
the executor and session use to survive them:

* **straggler** (``slow_nodes``) — a per-node slowdown factor scales
  everything the node serves (stage-1 aggregation, slow-hop receive,
  segment drain). The executor MEASURES the induced per-node service
  rates (``IOTimings.node_slowdown``) and the session feeds them into
  the next placement resolution, so ``placement="auto"`` visibly moves
  aggregator load off the straggler within one write.
* **dead aggregator** (``dead_aggregator=(slot, round)``) — the slot's
  node stops serving mid-write. Detection is wired to
  ``runtime.heartbeat.HeartbeatMonitor.dead_hosts()`` (the fault
  registers on the monitor; the executor polls); recovery routes the
  victim's file domains through a *repair map* (:func:`repair_map`)
  and replays their unfinished rounds on the repair slot. The victim's
  partially-drained segment is left torn on disk (truncated +
  ``.partial`` marker) exactly as the drain-thread fail-fast path
  leaves it, then detected and rewritten — every recovered write is
  byte-identical to the healthy oracle.
* **lost / delayed slow-hop message** (``lost`` / ``delayed``) — each
  loss charges a per-round retry timeout with exponential backoff and a
  re-send; more than ``max_retries`` losses raises
  :class:`UnrecoverableFaultError` (fail fast, never silently drop
  bytes). Delays push the round's completion out.
* **resize event** (``resize_at_write`` + ``resize_dead_nodes``) — not
  an executor fault: the scenario loop (benchmarks/degraded.py, the
  kill-and-resume tests) consumes it between writes via
  :func:`apply_resize`, which replans the writer shape through
  ``runtime.elastic.plan_remesh`` and redistributes the surviving
  requests — the loop replans instead of wedging.

Degraded placement is deliberately NOT a plan field: ``IOPlan.placement``
stays a bijection (the SPMD executors rely on it). A degraded *serve
map* (:func:`evacuation_map`) is an execution-level override — domain
``g`` served by slot ``serve[g]``, several domains may share a healthy
slot while a straggler's slots serve none — produced by the session's
measured re-resolution and consumed only by the host executor, which
serializes co-located domains per slot in its round timing.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping

import numpy as np

#: a measured per-node slowdown above this is treated as a straggler
#: (the session switches from bijective placement tuning to evacuation)
STRAGGLER_THRESHOLD = 1.5


class FaultError(RuntimeError):
    """Base class for injected-fault failures."""


class UnrecoverableFaultError(FaultError):
    """A fault exhausted its bounded recovery (e.g. a message lost more
    than ``max_retries`` times) — the write must fail, never silently
    drop bytes."""


class TornWriteError(FaultError):
    """The segment drain died mid-write. The file holds a detectable
    partial image: ``windows_written`` cb windows landed on disk and a
    ``<path>.partial`` marker was left next to it."""

    def __init__(self, path: str, windows_enqueued: int,
                 windows_written: int):
        super().__init__(
            f"torn write: {path} drain died after {windows_written} "
            f"windows ({windows_enqueued} enqueued); partial marker left")
        self.path = path
        self.windows_enqueued = windows_enqueued
        self.windows_written = windows_written


@dataclass(frozen=True)
class FaultSpec:
    """One write's injected faults (compose freely; all default off).

    Senders are indexed by their position in the executor's ``per_la``
    list (ranks for two-phase, local aggregators for TAM); slots and
    rounds are the plan's. All times are modeled seconds, consistent
    with the rest of the host executor's timing.
    """

    #: node -> slowdown factor (>= 1): scales the node's stage-1
    #: aggregation, its aggregators' slow-hop receive time, and its
    #: share of the segment drain
    slow_nodes: Mapping[int, float] = field(default_factory=dict)
    #: (aggregator slot, round): the slot's node dies entering that
    #: round; its domains re-route through a repair map and replay
    dead_aggregator: tuple[int, int] | None = None
    #: (sender, round) -> times lost: each loss costs a retry timeout
    #: (with backoff) + a re-send of that sender's round-r messages
    lost: Mapping[tuple[int, int], int] = field(default_factory=dict)
    #: (sender, round) -> seconds: the message arrives late, pushing
    #: the round's completion out by that much
    delayed: Mapping[tuple[int, int], float] = field(default_factory=dict)
    #: (segment, windows): the drain thread of ``<path>.seg<segment>``
    #: dies after that many cb windows (exercises the fail-fast torn
    #: write detection; the executor detects and rewrites)
    torn_window: tuple[int, int] | None = None
    #: scenario-loop event: the write index at which a resize happens
    #: (consumed by the loop via :func:`apply_resize`, not the executor)
    resize_at_write: int | None = None
    #: nodes lost at the resize event
    resize_dead_nodes: tuple[int, ...] = ()
    #: base retry timeout for a lost message (doubles per retry)
    retry_timeout_s: float = 1e-4
    #: bounded retries per message; more losses than this raises
    max_retries: int = 3
    #: dead-aggregator detection latency when no heartbeat monitor is
    #: supplied (a monitor's ``timeout_s`` wins when present)
    detection_s: float = 1e-3

    def slowdown(self, node: int) -> float:
        return max(float(self.slow_nodes.get(node, 1.0)), 1.0)

    @property
    def any_node_faults(self) -> bool:
        return bool(self.slow_nodes) or self.dead_aggregator is not None

    def retry_penalty(self, times_lost: int) -> float:
        """Summed timeout cost of ``times_lost`` consecutive losses
        (exponential backoff: the t-th retry waits 2^t longer)."""
        return self.retry_timeout_s * float(2 ** times_lost - 1)


def measure_node_slowdown(served_time, served_bytes) -> tuple[float, ...]:
    """Per-node slowdown factors from observed service: each node's
    seconds-per-byte rate normalized by the fastest busy node. Nodes
    serving nothing report 1.0 (no evidence). This is what the executor
    reports (``IOTimings.node_slowdown``) and the session's placement
    re-resolution consumes — the measured analogue of
    ``FaultSpec.slow_nodes``."""
    rates = []
    for t, b in zip(served_time, served_bytes):
        rates.append(float(t) / float(b) if b > 0 else None)
    busy = [r for r in rates if r is not None and r > 0]
    if not busy:
        return tuple(1.0 for _ in rates)
    floor = min(busy)
    return tuple(1.0 if r is None or floor <= 0 else max(r / floor, 1.0)
                 for r in rates)


def evacuation_map(n_aggregators: int, n_nodes: int, node_slowdown,
                   domain_bytes=None, *,
                   threshold: float = STRAGGLER_THRESHOLD,
                   dead_nodes=()) -> tuple[int, ...] | None:
    """Degraded serve map: domain -> serving slot, NOT required to be a
    bijection. Greedy effective-makespan assignment over slots whose
    per-slot load is scaled by the serving node's measured slowdown:
    a straggler's slots accrue effective time ``factor`` times faster,
    so they receive only what the healthy slots cannot absorb more
    cheaply (often nothing); dead nodes' slots are excluded outright.
    Domains co-located on one slot serialize — exactly how the host
    executor charges a serve map's round times.

    Returns ``None`` when no node exceeds ``threshold`` and nothing is
    dead — healthy machines keep the plan's bijective placement.
    """
    from repro_torch.core.placement import node_of_slot
    slow = [max(float(s), 1.0) for s in (node_slowdown or ())]
    slow += [1.0] * (n_nodes - len(slow))
    dead = set(int(n) for n in dead_nodes)
    if max(slow, default=1.0) <= threshold and not dead:
        return None
    slots = [s for s in range(n_aggregators)
             if node_of_slot(s, n_aggregators, n_nodes) not in dead]
    if not slots:
        raise UnrecoverableFaultError("no healthy aggregator slot left")
    if domain_bytes is None:
        domain_bytes = [1.0] * n_aggregators
    factor = {s: slow[node_of_slot(s, n_aggregators, n_nodes)]
              for s in slots}
    load = {s: 0.0 for s in slots}
    serve = [0] * n_aggregators
    order = sorted(range(n_aggregators),
                   key=lambda g: (-float(domain_bytes[g]), g))
    for g in order:
        db = max(float(domain_bytes[g]), 0.0)
        s = min(slots, key=lambda s: (load[s] + db * factor[s], s))
        serve[g] = s
        load[s] += db * factor[s]
    return tuple(serve)


def repair_map(serve, dead_slot: int, slot_load, n_aggregators: int,
               n_nodes: int, dead_nodes=()) -> tuple[tuple[int, ...],
                                                     int,
                                                     tuple[int, ...]]:
    """Re-route a dead slot's domains. Returns ``(new_serve,
    repair_slot, victim_domains)``: every domain the dead slot served
    moves to the healthy slot with the lightest current load (ties to
    the lowest slot id). The repair slot then serves several domains —
    serialized, like any degraded serve map."""
    from repro_torch.core.placement import node_of_slot
    dead = set(int(n) for n in dead_nodes)
    dead.add(node_of_slot(dead_slot, n_aggregators, n_nodes))
    healthy = [s for s in range(n_aggregators)
               if s != dead_slot
               and node_of_slot(s, n_aggregators, n_nodes) not in dead]
    if not healthy:
        raise UnrecoverableFaultError(
            f"aggregator slot {dead_slot} died and no healthy slot "
            "remains to repair through")
    repair = min(healthy, key=lambda s: (float(slot_load[s]), s))
    victims = tuple(g for g, s in enumerate(serve) if s == dead_slot)
    new_serve = tuple(repair if s == dead_slot else s for s in serve)
    return new_serve, repair, victims


def partial_marker(seg_path: str) -> str:
    """The torn-write marker next to a segment file: present whenever a
    drain died before the segment's full image landed."""
    return seg_path + ".partial"


def redistribute_requests(rank_requests, new_n_ranks: int):
    """Re-shard a request set onto a smaller writer: requests are
    dealt round-robin, in offset order (ties in rank order), onto the
    surviving ranks. The UNION of requests is unchanged, so the written
    bytes are byte-identical to the pre-resize writer's. Returns numpy
    triples."""
    from repro_torch.core._tensor import to_host
    offs = [to_host(o, np.int64) for o, _, _ in rank_requests]
    lens = [to_host(ln, np.int64) for _, ln, _ in rank_requests]
    data = [to_host(d, np.uint8) for _, _, d in rank_requests]
    o = np.concatenate(offs + [np.zeros(0, np.int64)])
    ln = np.concatenate(lens + [np.zeros(0, np.int64)])
    d = np.concatenate(data + [np.zeros(0, np.uint8)])
    # each rank's payload is packed in request order
    starts = np.concatenate([np.cumsum(x) - x for x in lens]
                            + [np.zeros(0, np.int64)])
    starts += np.repeat(np.cumsum([0] + [x.size for x in data])[:-1],
                        [x.size for x in offs])
    order = np.argsort(o, kind="stable")
    out = []
    for b in range(new_n_ranks):
        sel = order[b::new_n_ranks]
        bl = ln[sel]
        idx = (np.repeat(starts[sel] - (np.cumsum(bl) - bl), bl)
               + np.arange(int(bl.sum())))
        out.append((o[sel].copy(), bl.copy(), d[idx]))
    return out


def apply_resize(io, rank_requests, dead_nodes, heartbeat=None):
    """Consume a resize event mid write-loop: replan the writer shape
    through ``runtime.elastic.plan_remesh`` onto the surviving nodes
    and redistribute the request set, instead of wedging on the old
    shape. Returns ``(new_io, new_requests, ElasticPlan)``.

    The file layout (stripe size/count) is storage-side and survives
    the resize, so the shrunken writer produces byte-identical
    segments. The new writer carries the SAME session object — its
    shape is part of every session key, so the first post-resize write
    replans (a fresh entry), which is the point.
    """
    from repro_torch.runtime.elastic import plan_remesh
    dead = set(int(n) for n in dead_nodes)
    if heartbeat is not None:
        for n in dead:
            heartbeat.inject_failure(n)
        dead |= set(heartbeat.dead_hosts())
    survivors = [n for n in range(io.n_nodes) if n not in dead]
    if not survivors:
        raise UnrecoverableFaultError("resize event killed every node")
    q = io.n_ranks // io.n_nodes
    plan = plan_remesh(total_devices=len(survivors) * q,
                       model_parallel=1,
                       old_data_parallel=io.n_ranks)
    new_ranks = plan.mesh_shape[-2] if len(plan.mesh_shape) == 3 \
        else plan.mesh_shape[0]
    # nodes must divide ranks; keep up to one node per q surviving ranks
    new_nodes = 1
    while (new_nodes * 2 <= len(survivors)
           and new_ranks % (new_nodes * 2) == 0):
        new_nodes *= 2
    new_io = io.__class__(
        n_ranks=new_ranks, n_nodes=new_nodes,
        stripe_size=io.stripe_size, stripe_count=io.stripe_count,
        machine=io.machine, session=io.session, device=io.device)
    return new_io, redistribute_requests(rank_requests, new_ranks), plan
