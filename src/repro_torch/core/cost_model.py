"""Analytical congestion / cost model for two-phase I/O vs TAM.

Implements the paper's SIV-D analysis as a calibrated alpha-beta model
with three refinements the raw alpha-beta form misses but the paper's
measurements exhibit:

1. **Rounds.** ROMIO's Lustre driver writes at most one stripe per
   aggregator per round: rounds = total / (stripe_size * P_G). Each
   round re-runs the request exchange (paper SII).
2. **Incast congestion.** A receiver with S concurrent senders does not
   pay S * alpha linearly: queue processing collapses superlinearly
   (the paper's own MPI_Isend -> MPI_Issend fix is about exactly this
   message-queue overwhelm, SV). Modeled as
   alpha_eff = alpha * (1 + S / incast_knee).
3. **Per-request metadata processing.** ADIOI_Calc_my/others_req +
   derived-datatype construction cost scales with the number of
   offset-length pairs handled at the aggregator (dominant for E3SM-F's
   1.36e9 requests; Figs. 4-6 show it) — TAM shrinks it by the
   coalesce ratio.
4. **Round overlap.** The pipelined round engine (``core.rounds`` with
   ``IOConfig.pipeline``) exchanges round t+1 while draining round t,
   so each steady-state round pays ``max(comm, io)`` instead of the
   sum; ``Workload.overlap`` models the hidden fraction and
   :func:`optimal_cb` picks the collective-buffer size minimizing the
   pipelined total, the way :func:`optimal_PL` picks P_L.
5. **Slow-hop codec.** With ``Workload.slow_hop_ratio > 1`` (the
   ``core.codec`` wire transform enabled at a measured/modeled
   raw/wire ratio) the inter-node beta volume divides by the ratio and
   an encode+decode scan ``bytes * (1 + 1/ratio) / codec_bw`` is
   charged; :func:`slow_hop_codec_gain` is the break-even the planner's
   ``slow_hop_codec="auto"`` resolves against.

Message-count facts (paper SIV-D):
  two-phase:  P/P_G receives per GA per round;
              GA merge-sort O((P*k/P_G) log P).
  TAM intra:  P/P_L receives per LA (node-local);
              LA merge-sort O((P*k/P_L) log(P/P_L)).
  TAM inter:  P_L/P_G receives per GA per round;
              GA merge-sort O((P*k'/P_G) log P_L), k' = coalesced.

Validation anchors (tests/test_cost_model.py): end-to-end speedups in
the paper's 3-29x band at P=16384/256 nodes, and TAM-BTIO absolute time
~40 s at >5 GiB/s bandwidth (paper SV-B).
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Machine:
    """Latency/bandwidth constants, default-calibrated to the paper's
    Cray XC40 Aries + Lustre (56 OSTs) setup; TPU preset below."""

    alpha_inter: float = 5.0e-6   # per-message cost across nodes (s)
    alpha_intra: float = 4.0e-7   # per-message cost within a node (s)
    beta_inter: float = 1.0 / 8e9   # s per byte across nodes
    beta_intra: float = 1.0 / 40e9  # s per byte within a node
    sort_per_cmp: float = 4.0e-9  # s per compare-move in merge sort
    req_proc: float = 2.0e-7      # s per offset-length pair at receiver
    incast_knee: float = 2048     # senders beyond which queues collapse
    memcpy_bw: float = 5e9        # B/s local packing
    io_bw: float = 5.5e9          # aggregate file-system bandwidth (B/s)
    codec_bw: float = 50e9        # B/s slow-hop codec throughput (a
    # byte-scan like zero-run RLE or int8 quantization runs at memory
    # bandwidth; charged on raw bytes in + wire bytes out)

    @staticmethod
    def tpu_v5e() -> "Machine":
        # intra = ICI within pod, inter = DCI between pods; hosts do I/O
        return Machine(alpha_inter=5.0e-6, alpha_intra=1.0e-6,
                       beta_inter=1.0 / 25e9, beta_intra=1.0 / 50e9,
                       sort_per_cmp=1.0e-9, req_proc=5.0e-8,
                       incast_knee=512, memcpy_bw=100e9, io_bw=20e9,
                       codec_bw=150e9)

    def alpha_eff(self, senders: float) -> float:
        return self.alpha_inter * (1.0 + senders / self.incast_knee)


@dataclass(frozen=True)
class Workload:
    """One collective write (a checkpoint flush)."""

    P: int            # total processes (ranks/devices)
    nodes: int        # compute nodes (fast domains)
    P_G: int          # global aggregators (= Lustre stripe count)
    k: float          # avg noncontiguous requests per process
    total_bytes: float
    coalesce_ratio: float = 1.0   # k'/k after intra-node coalescing
    pair_bytes: int = 8
    stripe_size: float = 1 << 20  # 1 MiB (paper's setting)
    rounds_override: float | None = None  # executed rounds, when measured
    overlap: float = 0.0          # pipelined round engine: fraction of the
    # smaller of (per-round exchange, per-round drain) hidden in steady
    # state. 0 = serial rounds (sum), 1 = perfect double-buffered overlap
    # (each steady-state round pays max(comm, io) instead of comm + io).
    pipeline_depth: int = 2       # in-flight cb windows of the round engine
    # (1 = serial, 2 = the classic double buffer, k > 2 = a depth-k ring
    # that can absorb multi-round spikes in non-uniform round times; with
    # the model's uniform per-round phases every depth >= 2 hides the
    # same amount, so the depth only matters through pipeline_span /
    # optimal_depth when measured per-round times are supplied).
    slow_hop_ratio: float = 1.0   # slow-hop codec raw/wire ratio: the
    # inter-node beta term is divided by this (volume discount) and an
    # encode+decode term bytes*(1 + 1/ratio)/codec_bw is charged
    # (refinement 5 — core.codec). 1.0 = codec off; set via with_codec
    # (measured zero fraction -> Codec.modeled_ratio on the host path).
    locality: float | None = None  # fraction of each domain's bytes that
    # originate on the domain's HOME node (the node the canonical
    # packed placement serves it from — core.placement.node_of_slot).
    # None = uniform (1/nodes): every node contributes equally to every
    # domain, in which case aggregator placement cannot matter and
    # placement_cost ties for every permutation (refinement 6). Set via
    # with_locality, or superseded entirely by a measured per-(domain,
    # sender-node) byte matrix (the session's feedback loop).

    @property
    def q(self) -> int:
        return self.P // self.nodes

    @property
    def rounds(self) -> float:
        """Exchange rounds. Defaults to ROMIO's one-stripe-per-aggregator
        assumption; a measured executed round count (the round engine's
        ``RoundScheduler.n_rounds`` / host-path ``rounds_executed``)
        replaces the assumption via ``rounds_override``."""
        if self.rounds_override is not None:
            return max(float(self.rounds_override), 1.0)
        return max(self.total_bytes / (self.stripe_size * self.P_G), 1.0)

    @property
    def num_stripes(self) -> float:
        return max(self.total_bytes / self.stripe_size, 1.0)

    def senders_per_stripe(self, endpoints: float,
                           requests: float) -> float:
        """Distinct senders whose requests land in one stripe."""
        density = requests / self.num_stripes
        return min(endpoints, max(density, 1.0))


@dataclass(frozen=True)
class CostBreakdown:
    intra_comm: float = 0.0
    intra_sort: float = 0.0
    intra_memcpy: float = 0.0
    inter_comm: float = 0.0
    inter_req_proc: float = 0.0
    inter_sort: float = 0.0
    io: float = 0.0
    overlap_saved: float = 0.0    # time hidden by pipelining rounds
    codec: float = 0.0            # slow-hop encode+decode time

    @property
    def comm(self) -> float:
        return self.intra_comm + self.inter_comm + self.inter_req_proc

    @property
    def total(self) -> float:
        return (self.intra_comm + self.intra_sort + self.intra_memcpy
                + self.inter_comm + self.inter_req_proc + self.inter_sort
                + self.io + self.codec - self.overlap_saved)


def _log2(x: float) -> float:
    return math.log2(max(x, 2.0))


def _inter_phase(w: Workload, m: Machine, endpoints: float,
                 requests: float) -> tuple[float, float, float, float]:
    """(comm, req_proc, sort, codec) for an exchange from ``endpoints``
    senders holding ``requests`` total offset-length pairs, into P_G
    GAs. ``slow_hop_ratio > 1`` divides the beta byte volume (the codec
    discount, refinement 5) and charges the encode+decode scan."""
    senders = w.senders_per_stripe(endpoints, requests)
    ratio = max(w.slow_hop_ratio, 1e-9)
    bytes_per_ga = w.total_bytes / w.P_G
    comm = (w.rounds * m.alpha_eff(senders) * senders
            + m.beta_inter * bytes_per_ga / ratio)
    req_proc = m.req_proc * (requests / w.P_G)
    sort = m.sort_per_cmp * (requests / w.P_G) * _log2(endpoints)
    codec = (bytes_per_ga * (1.0 + 1.0 / ratio) / m.codec_bw
             if ratio != 1.0 else 0.0)
    return comm, req_proc, sort, codec


def _overlap_saved(w: Workload, inter_comm: float, io: float) -> float:
    """Time hidden by the pipelined round engine (refinement 4).

    A pipelined round loop exchanges round t+1 while draining round t,
    so each of the R-1 steady-state rounds pays ``max(comm_r, io_r)``
    instead of ``comm_r + io_r``; the prologue (first exchange) and
    epilogue (last drain) stay exposed. With per-round uniform phases
    the saving is ``overlap * (R - 1) * min(inter_comm, io) / R`` for
    every depth >= 2 (a deeper ring only helps non-uniform rounds —
    see :func:`pipeline_span`); depth 1 is the serial loop.
    """
    rounds = w.rounds
    if w.overlap <= 0.0 or rounds <= 1.0 or w.pipeline_depth <= 1:
        return 0.0
    return (min(1.0, w.overlap) * (rounds - 1.0)
            * min(inter_comm / rounds, io / rounds))


def twophase_cost(w: Workload, m: Machine = Machine()) -> CostBreakdown:
    """Original two-phase I/O: all P ranks -> P_G aggregators."""
    comm, rp, sort, codec = _inter_phase(w, m, w.P, w.P * w.k)
    io = w.total_bytes / m.io_bw
    return CostBreakdown(inter_comm=comm, inter_req_proc=rp,
                         inter_sort=sort, io=io, codec=codec,
                         overlap_saved=_overlap_saved(w, comm, io))


def tam_cost(w: Workload, P_L: int, m: Machine = Machine()) -> CostBreakdown:
    """TAM with P_L local aggregators (P_L == P degenerates to
    two-phase: the intra layer vanishes, nothing coalesces)."""
    if P_L >= w.P:
        return twophase_cost(w, m)
    senders_per_la = w.P / P_L
    meta_bytes = w.P * w.k * w.pair_bytes
    bytes_per_la = (w.total_bytes + meta_bytes) / P_L
    intra_comm = (m.alpha_intra * senders_per_la
                  + m.beta_intra * bytes_per_la)
    intra_sort = m.sort_per_cmp * (w.P * w.k / P_L) * _log2(w.P / P_L)
    intra_memcpy = bytes_per_la / m.memcpy_bw
    k_prime = w.P * w.k * w.coalesce_ratio
    comm, rp, sort, codec = _inter_phase(w, m, P_L, k_prime)
    # GA sort merges P_L pre-sorted streams: log factor is P_L not P
    sort = m.sort_per_cmp * (k_prime / w.P_G) * _log2(P_L)
    io = w.total_bytes / m.io_bw
    return CostBreakdown(intra_comm, intra_sort, intra_memcpy,
                         comm, rp, sort, io=io, codec=codec,
                         overlap_saved=_overlap_saved(w, comm, io))


def optimal_PL(w: Workload, m: Machine = Machine(),
               candidates: tuple[int, ...] | None = None
               ) -> tuple[int, CostBreakdown]:
    """Pick P_L minimizing f(P_L) + g(P_L) (paper SIV-D balance)."""
    if candidates is None:
        cands, c = [], 1
        while w.nodes * c <= w.P:
            cands.append(w.nodes * c)
            c *= 2
        if w.P not in cands:
            cands.append(w.P)
        candidates = tuple(cands)
    best = min(candidates, key=lambda pl: tam_cost(w, pl, m).total)
    return best, tam_cost(w, best, m)


def rounds_for_cb(w: Workload, cb_bytes: float) -> float:
    """Executed round count for a collective-buffer size: each aggregator
    drains its ``total_bytes / P_G`` domain ``cb_bytes`` per round."""
    return max(math.ceil(w.total_bytes / (cb_bytes * w.P_G)), 1)


def with_measured_rounds(w: Workload, rounds: float) -> Workload:
    """Pin the model's round count to an executed value (e.g. the host
    path's ``IOTimings.rounds_executed`` or ``RoundScheduler.n_rounds``)."""
    import dataclasses
    return dataclasses.replace(w, rounds_override=float(rounds))


def with_overlap(w: Workload, overlap: float = 1.0,
                 depth: int = 2) -> Workload:
    """Model the pipelined round engine: ``overlap`` of the smaller
    per-round phase (exchange vs drain) is hidden in steady state.
    ``depth`` is the number of in-flight cb windows (the ring size):
    1 restores the serial loop, 2 is the classic double buffer, and
    deeper rings matter only through :func:`pipeline_span` when
    per-round times are non-uniform."""
    import dataclasses
    return dataclasses.replace(w, overlap=float(overlap),
                               pipeline_depth=int(depth))


def with_codec(w: Workload, ratio: float) -> Workload:
    """Model the slow-hop codec at a raw/wire ``ratio`` (refinement 5):
    the inter-node beta volume divides by it and the encode+decode scan
    ``bytes * (1 + 1/ratio) / codec_bw`` is charged. ``ratio = 1``
    restores the codec-off model. The measured estimate comes from the
    payload zero fraction (``codec.zero_fraction`` +
    ``Codec.modeled_ratio`` — the host path wires this)."""
    import dataclasses
    return dataclasses.replace(w, slow_hop_ratio=float(ratio))


def with_locality(w: Workload, locality: float) -> Workload:
    """Model sender locality (refinement 6 — core.placement): a
    ``locality`` fraction of every domain's bytes originates on the
    domain's home node; :func:`placement_cost` charges the fast
    (intra-node) rates for the bytes a placement keeps home-matched.
    ``1/nodes`` restores the uniform (placement-indifferent) model."""
    import dataclasses
    return dataclasses.replace(w, locality=float(locality))


def placement_cost(w: Workload, m: Machine = Machine(),
                   placement=None, n_nodes: int | None = None, *,
                   domain_bytes=None, node_bytes=None,
                   node_slowdown=None) -> float:
    """Modeled seconds of the inter phase under an aggregator placement
    (refinement 6): the per-node MAKESPAN of the slow-hop exchange when
    domain ``g`` is served by slot ``placement[g]`` (canonical
    slot->node map, ``core.placement.node_of_slot``).

    Two effects the flat model cannot see:

    * **fast-hop/slow-hop split** — bytes whose sender sits on the
      serving slot's node move at the intra rates (``alpha_intra`` /
      ``beta_intra``); the rest pay the inter rates with the incast
      knee (``alpha_eff``) and the slow-hop codec discount. The split
      comes from ``node_bytes`` (the measured per-(domain, sender-node)
      matrix the session feeds back) or, absent a measurement, from
      ``w.locality`` (``None`` = uniform = placement-indifferent).
    * **per-node load balance** — each domain's exchange cost lands on
      its serving node; the returned value is the max over nodes, so a
      placement that packs the heavy (or the only active) domains onto
      one node is charged for the pileup. ``domain_bytes`` supplies
      measured per-domain loads (default: uniform split).

    ``node_slowdown`` (per-node factors >= 1 — the executor's measured
    ``IOTimings.node_slowdown``, or a ``FaultSpec.slow_nodes`` model)
    scales each serving node's charge: a straggling node is that much
    more expensive per byte it serves, so the makespan argmin steers
    load off it (the degraded half of the session feedback loop).

    ``placement=None`` means the identity (placement off). The
    ``"auto"`` policy resolves by argmin of this function, so auto is
    never modeled-worse than any named policy — the invariant
    ``benchmarks/check_regression.py`` gates.
    """
    nodes = int(n_nodes if n_nodes is not None else w.nodes)
    if placement is None:
        P_G = w.P_G
        placement = tuple(range(P_G))
    else:
        placement = tuple(int(p) for p in placement)
        P_G = len(placement)
    nodes = max(nodes, 1)
    if node_bytes is not None:
        nb = [[float(b) for b in row] for row in node_bytes]
    else:
        if domain_bytes is None:
            domain_bytes = [w.total_bytes / P_G] * P_G
        loc = w.locality if w.locality is not None else 1.0 / nodes
        loc = min(max(float(loc), 0.0), 1.0)
        nb = []
        for g in range(P_G):
            home = g * nodes // P_G
            db = float(domain_bytes[g])
            if nodes == 1:
                nb.append([db])
                continue
            row = [db * (1.0 - loc) / (nodes - 1)] * nodes
            row[home] = db * loc
            nb.append(row)
    ratio = max(w.slow_hop_ratio, 1e-9)
    S = w.senders_per_stripe(w.P, w.P * w.k)
    slow_f = [max(float(s), 1.0) for s in (node_slowdown or ())]
    slow_f += [1.0] * (nodes - len(slow_f))
    node_load = [0.0] * nodes
    for g in range(P_G):
        serving = placement[g] * nodes // P_G      # node_of_slot
        total_g = sum(nb[g])
        if total_g <= 0.0:
            continue
        fast = nb[g][serving]
        slow = total_g - fast
        s_slow = S * slow / total_g
        s_fast = S - s_slow
        comm_g = (w.rounds * (m.alpha_eff(s_slow) * s_slow
                              + m.alpha_intra * s_fast)
                  + m.beta_inter * slow / ratio + m.beta_intra * fast)
        node_load[serving] += comm_g * slow_f[serving]
    return max(node_load)


def slow_hop_codec_gain(w: Workload, m: Machine = Machine(),
                        ratio: float | None = None) -> float:
    """Modeled seconds SAVED per global aggregator by enabling the
    slow-hop codec at ``ratio`` (default: the workload's) — the beta
    volume discount minus the encode+decode cost. Positive means the
    codec pays for itself; ``compile_plan``'s ``slow_hop_codec="auto"``
    enables the codec exactly when this is positive."""
    r = max(float(ratio if ratio is not None else w.slow_hop_ratio), 1e-9)
    bytes_per_ga = w.total_bytes / w.P_G
    saving = m.beta_inter * bytes_per_ga * (1.0 - 1.0 / r)
    cost = bytes_per_ga * (1.0 + 1.0 / r) / m.codec_bw
    return saving - cost


def pipeline_span(comm_rounds, io_rounds, depth: int) -> float:
    """Exact makespan of a depth-k bounded-buffer round pipeline.

    ``comm_rounds[t]`` / ``io_rounds[t]`` are round t's exchange and
    drain times (any non-uniformity is welcome — this is what a deeper
    ring exploits). The ring holds ``depth`` window buffers: the
    exchange of round t reuses the buffer drained in round t - depth,
    so

        finish_ex[t] = max(finish_ex[t-1], finish_dr[t-depth]) + comm[t]
        finish_dr[t] = max(finish_dr[t-1], finish_ex[t]) + io[t]

    ``depth=1`` degenerates to the serial sum; ``depth=2`` reproduces
    the closed form ``c_0 + sum max(c_t, i_{t-1}) + i_{R-1}`` the host
    path measured before depth-k existed.
    """
    comm = [float(c) for c in comm_rounds]
    io = [float(i) for i in io_rounds]
    n = len(comm)
    if n == 0:
        return 0.0
    d = max(1, min(int(depth), n))
    if d == 1:
        return sum(comm) + sum(io)
    fin_ex = [0.0] * n
    fin_dr = [0.0] * n
    for t in range(n):
        start = fin_ex[t - 1] if t else 0.0
        if t - d >= 0:
            start = max(start, fin_dr[t - d])
        fin_ex[t] = start + comm[t]
        fin_dr[t] = max(fin_dr[t - 1] if t else 0.0, fin_ex[t]) + io[t]
    return fin_dr[-1]


def optimal_depth(w: Workload | None = None, m: Machine = Machine(),
                  P_L: int | None = None,
                  cb_bytes: float | None = None,
                  depths: tuple[int, ...] = (1, 2, 3, 4),
                  round_times=None) -> tuple[int, float]:
    """Pick the pipeline-ring depth minimizing the round-loop makespan,
    the way :func:`optimal_cb` picks the collective-buffer size.

    Two modes:

    * **measured** — ``round_times = (comm_rounds, io_rounds)`` from an
      executed run (the host path's per-round arrays): the span is
      computed exactly per candidate depth, so a depth-k ring's ability
      to absorb multi-round spikes is visible.
    * **modeled** — from ``w`` (and ``cb_bytes`` to pin the round
      count): per-round phases are uniform, every depth >= 2 ties and
      the smallest winning depth is returned (deeper rings cost k x
      window memory for no modeled gain — see
      ``rounds.peak_aggregator_buffer_elems``).

    Returns ``(depth, span_seconds)``. Ties go to the smallest depth.
    """
    if round_times is not None:
        comm_rounds, io_rounds = round_times
        comm_rounds = [float(c) for c in comm_rounds]
        io_rounds = [float(i) for i in io_rounds]
        spans = {d: pipeline_span(comm_rounds, io_rounds, d)
                 for d in depths}
    else:
        if w is None:
            raise ValueError("need a Workload or measured round_times")
        wc = w if cb_bytes is None else \
            with_measured_rounds(w, rounds_for_cb(w, cb_bytes))
        cost = tam_cost(wc, P_L, m) if P_L is not None else \
            twophase_cost(wc, m)
        # uniform per-round phases: the span has a closed form (every
        # depth >= 2 ties), so no per-round array is materialized even
        # for million-round schedules
        n = max(float(wc.rounds), 1.0)
        c_r, i_r = cost.inter_comm / n, cost.io / n
        spans = {d: (n * (c_r + i_r) if min(d, n) <= 1
                     else c_r + (n - 1.0) * max(c_r, i_r) + i_r)
                 for d in depths}
    best_d, best_s = None, None
    for d in depths:
        if best_s is None or spans[d] < best_s - 1e-15:
            best_d, best_s = d, spans[d]
    return best_d, best_s


def cb_candidates(domain_bytes: float, stripe_bytes: float, *,
                  min_cb_bytes: int = 1,
                  max_cb_bytes: int | None = None) -> tuple[int, ...]:
    """Collective-buffer sizes satisfying the round-partition invariants.

    Every candidate ``c`` is stripe-aligned (``c % stripe == 0`` or
    ``stripe % c == 0`` — ``RoundScheduler``'s validation) and, when
    ``domain_bytes`` is an exact stripe multiple, divides it evenly (the
    ``domain_len % cb`` invariant the SPMD round partition enforces).
    Non-stripe-divisible domains (paper workloads whose total does not
    divide by P_G, handled with a ceil round count) relax divisibility
    and keep alignment only. Candidates are power-of-two spaced:
    sub-stripe divisors of the stripe, then stripe multiples up to the
    whole domain (``max_cb_bytes`` bounds aggregator memory).
    """
    domain_bytes = max(int(round(domain_bytes)), 1)
    stripe_bytes = max(int(round(stripe_bytes)), 1)
    exact = domain_bytes % stripe_bytes == 0
    if not exact:   # round the domain up to a whole number of stripes
        domain_bytes = -(-domain_bytes // stripe_bytes) * stripe_bytes
    cands: set[int] = set()
    c = stripe_bytes
    while c >= max(min_cb_bytes, 1):          # sub-stripe divisors
        if not exact or domain_bytes % c == 0:
            cands.add(c)
        if c % 2:
            break
        c //= 2
    c = stripe_bytes
    while c <= domain_bytes:                  # stripe multiples
        if not exact or domain_bytes % c == 0:
            cands.add(c)
        c *= 2
    cands.add(domain_bytes)                   # single round
    cands = {c for c in cands
             if c >= min_cb_bytes
             and (max_cb_bytes is None or c <= max_cb_bytes)}
    if not cands:   # memory bound excludes everything: smallest legal cb
        cands = {max(stripe_bytes, min_cb_bytes)}
    return tuple(sorted(cands))


def optimal_cb(w: Workload, m: Machine = Machine(),
               P_L: int | None = None,
               candidates: tuple[int, ...] | None = None,
               min_cb_bytes: int = 1,
               max_cb_bytes: int | None = None
               ) -> tuple[int, CostBreakdown]:
    """Pick ``cb_buffer_size`` (bytes) minimizing the modeled total, the
    way :func:`optimal_PL` picks P_L.

    The trade-off: a small cb means many rounds — each re-paying the
    incast latency ``alpha_eff(senders)`` — but little aggregator memory
    and (with ``w.overlap > 0``) more steady-state rounds in which the
    pipelined engine hides ``min(comm, io)``; a large cb means few
    rounds but ``O(cb)`` aggregator buffering (bounded by
    ``max_cb_bytes``). Every candidate obeys the round-partition
    invariants (see :func:`cb_candidates`). Returns
    ``(cb_bytes, CostBreakdown at that cb)``.
    """
    if candidates is None:
        candidates = cb_candidates(w.total_bytes / w.P_G, w.stripe_size,
                                   min_cb_bytes=min_cb_bytes,
                                   max_cb_bytes=max_cb_bytes)

    def cost(cb: int) -> CostBreakdown:
        wc = with_measured_rounds(w, rounds_for_cb(w, cb))
        return tam_cost(wc, P_L, m) if P_L is not None else \
            twophase_cost(wc, m)

    best = min(candidates, key=lambda cb: cost(cb).total)
    return best, cost(best)


def optimal_cb_and_depth(w: Workload, m: Machine = Machine(),
                         P_L: int | None = None,
                         candidates: tuple[int, ...] | None = None,
                         depths: tuple[int, ...] = (1, 2, 3, 4),
                         min_cb_bytes: int = 1,
                         max_cb_bytes: int | None = None
                         ) -> tuple[int, int, float]:
    """Jointly pick (cb_bytes, pipeline depth): for every legal cb the
    best ring depth's exact :func:`pipeline_span` replaces the serial
    ``inter_comm + io`` round phases, and the (cb, depth) pair with the
    smallest resulting total wins. This is what ``pipeline_depth="auto"``
    resolves through at plan time. Returns
    ``(cb_bytes, depth, total_seconds)``."""
    if candidates is None:
        candidates = cb_candidates(w.total_bytes / w.P_G, w.stripe_size,
                                   min_cb_bytes=min_cb_bytes,
                                   max_cb_bytes=max_cb_bytes)
    best: tuple[float, int, int] | None = None
    for cb in candidates:
        wc = with_measured_rounds(w, rounds_for_cb(w, cb))
        cost = tam_cost(wc, P_L, m) if P_L is not None else \
            twophase_cost(wc, m)
        fixed = (cost.intra_comm + cost.intra_sort + cost.intra_memcpy
                 + cost.inter_req_proc + cost.inter_sort + cost.codec)
        d, span = optimal_depth(wc, m, P_L=P_L, depths=depths)
        total = fixed + span
        if best is None or total < best[0] - 1e-15:
            best = (total, cb, d)
    return best[1], best[2], best[0]


def read_cost(w: Workload, m: Machine = Machine(), *,
              node_cache: bool = True,
              replicas: float = 1.0) -> CostBreakdown:
    """Modeled cost of a planned collective read (a restore).

    The write model run in reverse: global aggregators read the file
    (``io``), ship each file-domain window over the slow hop, and the
    window fans out to the reader ranks that requested it.

    ``node_cache=True`` models the host executor's node-level read
    cache: one elected fetcher per node pulls each window over the slow
    hop exactly once and co-located readers are served at the intra
    rates, so the slow-hop endpoint count is ``min(nodes, P)`` and the
    slow-hop byte volume is independent of ``replicas`` (co-located
    readers requesting the same bytes — the restore fan-out case).
    ``node_cache=False`` is the PR-3 broadcast: every reader rank
    fetches directly, paying the incast knee at P endpoints and
    re-shipping overlapping bytes ``min(replicas, q)`` times.
    """
    ratio = max(w.slow_hop_ratio, 1e-9)
    bytes_per_ga = w.total_bytes / w.P_G
    io = w.total_bytes / m.io_bw
    codec = (bytes_per_ga * (1.0 + 1.0 / ratio) / m.codec_bw
             if ratio != 1.0 else 0.0)
    if node_cache:
        fetchers = float(max(min(w.nodes, w.P), 1))
        inter = (w.rounds * m.alpha_eff(fetchers) * fetchers
                 + m.beta_inter * bytes_per_ga / ratio)
        q = max(w.q, 1)
        node_share = w.total_bytes / max(w.nodes, 1)
        intra = w.rounds * m.alpha_intra * q + m.beta_intra * node_share
        memcpy = node_share / m.memcpy_bw
        return CostBreakdown(intra_comm=intra, intra_memcpy=memcpy,
                             inter_comm=inter, io=io, codec=codec,
                             overlap_saved=_overlap_saved(w, inter, io))
    dup = max(min(float(replicas), float(max(w.q, 1))), 1.0)
    senders = w.senders_per_stripe(w.P, w.P * max(w.k, 1.0))
    inter = (w.rounds * m.alpha_eff(senders) * senders
             + m.beta_inter * bytes_per_ga * dup / ratio)
    return CostBreakdown(inter_comm=inter, io=io, codec=codec,
                         overlap_saved=_overlap_saved(w, inter, io))


def optimal_read_cb(w: Workload, m: Machine = Machine(),
                    candidates: tuple[int, ...] | None = None, *,
                    node_cache: bool = True,
                    min_cb_bytes: int = 1,
                    max_cb_bytes: int | None = None
                    ) -> tuple[int, CostBreakdown]:
    """Read-direction :func:`optimal_cb`: pick the collective-buffer
    size minimizing the modeled :func:`read_cost` total. The trade-off
    mirrors the write side — small cb = many rounds, each re-paying the
    per-round fetch latency; large cb = O(cb) node-cache memory."""
    if candidates is None:
        candidates = cb_candidates(w.total_bytes / w.P_G, w.stripe_size,
                                   min_cb_bytes=min_cb_bytes,
                                   max_cb_bytes=max_cb_bytes)

    def cost(cb: int) -> CostBreakdown:
        wc = with_measured_rounds(w, rounds_for_cb(w, cb))
        return read_cost(wc, m, node_cache=node_cache)

    best = min(candidates, key=lambda cb: cost(cb).total)
    return best, cost(best)


def optimal_read_depth(w: Workload | None = None,
                       m: Machine = Machine(), *,
                       cb_bytes: float | None = None,
                       node_cache: bool = True,
                       depths: tuple[int, ...] = (1, 2, 3, 4),
                       round_times=None) -> tuple[int, float]:
    """Read-direction :func:`optimal_depth`. Measured mode (per-round
    ``(comm_rounds, io_rounds)`` from an executed read) delegates to
    the exact :func:`pipeline_span`; modeled mode uses
    :func:`read_cost`'s uniform per-round phases (every depth >= 2
    ties, smallest wins)."""
    if round_times is not None:
        return optimal_depth(m=m, depths=depths, round_times=round_times)
    if w is None:
        raise ValueError("need a Workload or measured round_times")
    wc = w if cb_bytes is None else \
        with_measured_rounds(w, rounds_for_cb(w, cb_bytes))
    cost = read_cost(wc, m, node_cache=node_cache)
    n = max(float(wc.rounds), 1.0)
    c_r, i_r = cost.inter_comm / n, cost.io / n
    spans = {d: (n * (c_r + i_r) if min(d, n) <= 1
                 else c_r + (n - 1.0) * max(c_r, i_r) + i_r)
             for d in depths}
    best_d, best_s = None, None
    for d in depths:
        if best_s is None or spans[d] < best_s - 1e-15:
            best_d, best_s = d, spans[d]
    return best_d, best_s


def optimal_read_cb_and_depth(w: Workload, m: Machine = Machine(),
                              candidates: tuple[int, ...] | None = None,
                              depths: tuple[int, ...] = (1, 2, 3, 4), *,
                              node_cache: bool = True,
                              min_cb_bytes: int = 1,
                              max_cb_bytes: int | None = None
                              ) -> tuple[int, int, float]:
    """Jointly pick (cb_bytes, pipeline depth) for a read, the way
    :func:`optimal_cb_and_depth` does for writes: per candidate cb the
    best ring depth's span replaces the serial fetch + fan-out round
    phases. This is what read-direction ``pipeline_depth="auto"``
    resolves through. Returns ``(cb_bytes, depth, total_seconds)``."""
    if candidates is None:
        candidates = cb_candidates(w.total_bytes / w.P_G, w.stripe_size,
                                   min_cb_bytes=min_cb_bytes,
                                   max_cb_bytes=max_cb_bytes)
    best: tuple[float, int, int] | None = None
    for cb in candidates:
        wc = with_measured_rounds(w, rounds_for_cb(w, cb))
        cost = read_cost(wc, m, node_cache=node_cache)
        fixed = (cost.intra_comm + cost.intra_sort + cost.intra_memcpy
                 + cost.inter_req_proc + cost.inter_sort + cost.codec)
        d, span = optimal_read_depth(wc, m, node_cache=node_cache,
                                     depths=depths)
        total = fixed + span
        if best is None or total < best[0] - 1e-15:
            best = (total, cb, d)
    return best[1], best[2], best[0]


def receives_per_global_aggregator(w: Workload, P_L: int | None) -> float:
    """The paper's congestion metric (Fig. 2), per round."""
    return (w.P if P_L is None or P_L >= w.P else P_L) / w.P_G


def sort_complexity(w: Workload, P_L: int | None) -> float:
    """Compare-count of the offset merge-sorts (paper SIV-D)."""
    if P_L is None or P_L >= w.P:
        return (w.P * w.k / w.P_G) * _log2(w.P)
    k_prime = w.k * w.coalesce_ratio
    return ((w.P * k_prime / w.P_G) * _log2(P_L)
            + (w.P * w.k / P_L) * _log2(w.P / P_L))


def speedup(w: Workload, P_L: int, m: Machine = Machine()) -> float:
    """End-to-end two-phase / TAM time ratio."""
    return twophase_cost(w, m).total / tam_cost(w, P_L, m).total


# ---------------------------------------------------------------------------
# Paper workloads (Table I).
# ---------------------------------------------------------------------------

def e3sm_g(P: int, nodes: int) -> Workload:
    return Workload(P=P, nodes=nodes, P_G=56, k=1.74e8 / P,
                    total_bytes=85 * 2**30, coalesce_ratio=0.5)


def e3sm_f(P: int, nodes: int) -> Workload:
    return Workload(P=P, nodes=nodes, P_G=56, k=1.36e9 / P,
                    total_bytes=14 * 2**30, coalesce_ratio=0.5)


def btio(P: int, nodes: int) -> Workload:
    n_req = 512**2 * 40 * math.sqrt(P)
    # paper SV-B: 1.34e9 requests coalesce to 2.36e7 at 256 nodes
    return Workload(P=P, nodes=nodes, P_G=56, k=n_req / P,
                    total_bytes=200 * 2**30, coalesce_ratio=0.0176)


def s3d(P: int, nodes: int, y: int | None = None,
        z: int | None = None) -> Workload:
    side = max(round(P ** (1 / 3)), 1)
    y = y or side
    z = z or side
    return Workload(P=P, nodes=nodes, P_G=56, k=800**2 * y * z / P,
                    total_bytes=61 * 2**30, coalesce_ratio=0.05)
