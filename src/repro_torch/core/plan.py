"""Unified collective-I/O plan IR (the schedule, compiled once).

The PyTorch port's copy of the reference planner (``repro.core.plan``):
the schedule is compiled ONCE into an explicit, immutable
:class:`IOPlan` by the pass pipeline of ``repro_torch.core.passes``, and
then executed by the rank-axis executor (``repro_torch.core.spmd_exec``)
— every rank of the ``(node, lagg, lmem)`` mesh is a row of one tensor on
one device. The planner is pure Python, so it compiles field-for-field
the plans the reference compiles (``tests/golden_plans.json``).

What the IR captures
--------------------
* **File-domain assignment** — ``layout`` + ``n_aggregators``:
  aggregator g owns domain ``[g * domain_len, (g+1) * domain_len)``.
* **Round schedule** — ``cb`` elements per aggregator per round,
  ``n_rounds = domain_len / cb`` (:class:`RoundScheduler`). The
  single-shot exchange is the 1-round plan (``cb == domain_len``).
* **Aggregation topology** — ``method``: ``"twophase"`` or ``"tam"``;
  ``"auto"`` resolves via the cost model at plan time.
* **Direction** — ``"write"`` or ``"read"`` (the port executes writes).
* **Pipeline depth** — ``pipeline_depth`` in-flight cb windows.
* **Static capacities** — per-rank request/payload capacities; the
  executor keeps them as the reference does, because drop stats and
  byte identity depend on them.

:func:`plan_from_fields` rebuilds a plan from the field dict the
reference's golden-plan serializer writes, so a plan compiled by the
reference can be executed by the port unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.core.domains import FileLayout
from repro_torch.core.requests import ELEM_BYTES


@dataclass(frozen=True)
class IOConfig:
    """Static capacities + schedule knobs for the collective-I/O paths.

    req_cap:        per-rank request-list capacity.
    data_cap:       per-rank payload capacity (elements).
    coalesce_cap:   post-coalesce metadata capacity forwarded by a local
                    aggregator (TAM stage 2). Patterns that coalesce well
                    (BTIO/S3D-like) allow coalesce_cap << lmem * req_cap —
                    that is TAM's inter-node metadata saving.
    cb_buffer_size: aggregator collective-buffer elements per round
                    (ROMIO's romio_cb_buffer_size). ``None`` = one round
                    covering the whole domain (the single-shot
                    schedule); ``"auto"`` lets ``cost_model.optimal_cb``
                    pick the size minimizing the modeled (pipelined)
                    total at plan time.
    pipeline:       pipeline the round loop — round t+1's exchange
                    overlaps round t's window drain (byte-identical;
                    see ``repro_torch.core.rounds``).
    pipeline_depth: in-flight cb windows when ``pipeline`` is set
                    (ignored otherwise): 2 = the classic double buffer,
                    k = a depth-k ring holding k windows at k x the
                    window memory; ``"auto"`` picks depth jointly with
                    cb via ``cost_model.optimal_cb_and_depth``.
    axis_names:     (node, lagg, lmem) mesh-axis names.
    slow_hop_codec: per-round wire transform of the slow-axis payload
                    (``core.codec`` registry: "identity", "rle",
                    "ef-int8"). ``None`` = no transform; ``"auto"``
                    enables the lossless byte codec when the modeled
                    slow-hop saving beats the encode cost
                    (``cost_model.slow_hop_codec_gain``).
    placement:      aggregator placement (``core.placement``): which
                    slot serves each file domain, as a policy name
                    ("packed", "spread", "node_balanced"), an explicit
                    permutation tuple, or ``"auto"`` (argmin of
                    ``cost_model.placement_cost``). ``None`` = off —
                    the legacy identity path.
    kernel_fusion:  per-round kernel lowering (``passes.lower_kernels``):
                    ``"fused_round"`` drains each write window through
                    ONE fused kernel call (sort + dual pack,
                    ``kernels.fused_round``) instead
                    of three separate kernel launches / HBM round
                    trips; ``None`` = the unfused jnp path. Byte
                    -identical by contract (rounds_checks fuzz).
    transport:      which executor ships the exchange's bytes
                    (``core.transport`` registry, validated by
                    ``passes.resolve_transport``): ``"mp"`` = the real
                    multi-process backend (``checkpoint.mp_exec``) —
                    forked worker processes, shared-memory arenas for
                    the intra-node fast hop, localhost sockets for the
                    inter-node slow hop, wall-clock round timings;
                    ``None`` = the in-process executors with modeled
                    time. Byte-identical by contract (rounds_checks
                    fuzz vs the host oracle).
    """

    req_cap: int
    data_cap: int
    coalesce_cap: int | None = None
    cb_buffer_size: int | str | None = None
    pipeline: bool = False
    pipeline_depth: int | str = 2
    axis_names: tuple[str, str, str] = ("node", "lagg", "lmem")
    slow_hop_codec: str | None = None
    placement: str | tuple[int, ...] | None = None
    kernel_fusion: str | None = None
    transport: str | None = None


@dataclass(frozen=True)
class RoundScheduler:
    """Static partition of each aggregator's file domain into rounds.

    layout:         striped file layout (element units).
    n_aggregators:  global aggregators (== slow-axis size in SPMD).
    cb_buffer_size: collective-buffer elements per aggregator per round;
                    ``None`` = one round == the single-shot behavior.
    """

    layout: FileLayout
    n_aggregators: int
    cb_buffer_size: int | None = None

    def __post_init__(self):
        if self.layout.file_len % self.n_aggregators:
            raise ValueError("file_len must divide evenly among aggregators")
        cb = self.cb
        if self.domain_len % cb:
            raise ValueError(
                f"cb_buffer_size {cb} must divide domain_len "
                f"{self.domain_len} (stripe-aligned rounds)")
        s = self.layout.stripe_size
        if cb % s and s % cb:
            raise ValueError(
                f"cb_buffer_size {cb} must align with stripe_size {s}")

    @property
    def domain_len(self) -> int:
        return self.layout.file_len // self.n_aggregators

    @property
    def cb(self) -> int:
        return (self.cb_buffer_size if self.cb_buffer_size is not None
                else self.domain_len)

    @property
    def n_rounds(self) -> int:
        return -(-self.domain_len // self.cb)

    def max_spans(self, data_cap: int) -> int:
        """Windows one request (length <= data_cap) can straddle."""
        return data_cap // self.cb + 2

    def window_of(self, offsets):
        """Round in which an offset is exchanged (domain-local window)."""
        return (offsets % self.domain_len) // self.cb


@dataclass(frozen=True)
class IOPlan:
    """The compiled schedule of one collective-I/O operation.

    Immutable and hashable: two entry points given the same workload
    must compile the SAME plan (asserted by tests/test_plan.py), which
    is what guarantees the SPMD and host executors run one schedule.

    layout / n_aggregators: file-domain assignment (aggregator g owns
        the contiguous domain-local span of its stripes).
    cb / n_rounds: the round window schedule; ``cb == domain_len`` is
        the single-shot (1-round) schedule.
    method: "twophase" | "tam" (resolved — never "auto" here).
    direction: "write" | "read".
    pipeline_depth: resolved in-flight window count (1 = serial).
    req_cap / data_cap / coalesce_cap: static capacities for the SPMD
        backend; advisory for the host backend (numpy is dynamic).
    tam_read_fallback: True when method == "tam" and direction ==
        "read": under SPMD every rank participates in every collective
        hop, so a TAM read lowers to the same slow-axis window
        broadcast as the two-phase read — the plan records the fallback
        EXPLICITLY instead of silently aliasing (``make_tam_read``
        asserts it; see that docstring for why the paths coincide).
    slow_hop_codec: resolved per-round wire codec (never "auto" here;
        ``None`` = no transform). Both executors read it — the round
        engine wraps the ``exchange``/``drain`` pair, the host
        executor charges encoded bytes — so one plan field governs the
        wire format everywhere (ARCHITECTURE.md § slow-hop codec).
    placement: resolved aggregator placement (never "auto" or a policy
        name here): ``placement[g]`` is the slot serving domain ``g``
        (``core.placement``), or ``None`` when placement is off. Both
        executors read it — the SPMD round engine routes destinations
        through the permutation and permutes the domain shards back,
        the host executor charges the fast-hop/slow-hop split the
        placement induces — so one plan field governs where aggregation
        lands everywhere (ARCHITECTURE.md § sessions and placement).
    kernel_fusion: resolved per-round kernel lowering (the
        ``lower_kernels`` pass): ``"fused_round"`` = the fused
        drain kernel of ``kernels.fused_round`` on the write drain, and
        the ``zero_skip_decode`` kernel replacing the rle decode
        scatter on the read fetch; ``None`` = the unfused jnp path.
        Only the SPMD backend consumes it (the host executor is numpy).
    transport: resolved byte-moving backend (the ``resolve_transport``
        pass; never an unregistered name here): ``"mp"`` dispatches
        ``checkpoint.host_io`` writes/reads to the multi-process
        executor (``checkpoint.mp_exec`` — real processes, shm fast
        hop, socket slow hop, measured wall-clock rounds); ``None`` =
        the in-process executors. Part of the session plan-cache key,
        and ``IOTimings.transport`` records which backend produced a
        measurement so feedback never crosses executors.
    """

    layout: FileLayout
    n_aggregators: int
    cb: int
    n_rounds: int
    method: str
    direction: str
    pipeline_depth: int
    req_cap: int
    data_cap: int
    coalesce_cap: int | None
    axis_names: tuple[str, str, str]
    tam_read_fallback: bool = False
    slow_hop_codec: str | None = None
    placement: tuple[int, ...] | None = None
    kernel_fusion: str | None = None
    transport: str | None = None

    @property
    def domain_len(self) -> int:
        return self.layout.file_len // self.n_aggregators

    @property
    def in_flight_windows(self) -> int:
        """Window buffers live at once (the k x memory price)."""
        return max(1, min(self.pipeline_depth, self.n_rounds))

    def scheduler(self) -> RoundScheduler:
        return RoundScheduler(self.layout, self.n_aggregators, self.cb)

    def describe(self) -> str:
        """One line per field (plus the derived schedule numbers) —
        the human-readable form pass traces and test failure messages
        print. Field order follows the dataclass so two describes line
        up for eyeball comparison; :func:`plan_diff` gives the
        field-level delta."""
        from dataclasses import fields
        lines = ["IOPlan:"]
        for f in fields(self):
            v = getattr(self, f.name)
            if f.name == "layout":
                v = (f"FileLayout(stripe_size={v.stripe_size}, "
                     f"stripe_count={v.stripe_count}, "
                     f"file_len={v.file_len})")
                lines.append(f"  {f.name:<17} = {v}")
            else:
                lines.append(f"  {f.name:<17} = {v!r}")
        if isinstance(self.cb, int) and self.cb > 0:
            lines.append(f"  {'domain_len':<17} = {self.domain_len!r}"
                         " (derived)")
            lines.append(f"  {'in_flight_windows':<17} = "
                         f"{self.in_flight_windows!r} (derived)")
        return "\n".join(lines)


def plan_diff(a: IOPlan, b: IOPlan) -> str:
    """Field-level textual diff of two plans: one ``field: a -> b``
    line per differing field, ``""`` when the plans are equal. Wired
    into pass tracing (``passes.trace_report``) and property-test
    failure messages so a bad rewrite names the field it broke."""
    from dataclasses import fields
    lines = []
    for f in fields(IOPlan):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if va != vb:
            lines.append(f"{f.name}: {va!r} -> {vb!r}")
    return "\n".join(lines)


def _default_workload(layout: FileLayout, cfg: IOConfig, n_aggregators: int,
                      n_nodes: int, n_ranks: int, unit_bytes: int):
    """Cost-model Workload for plan-time auto resolution when the caller
    did not supply a measured one (mirrors the PR-2 ``"auto"`` cb
    resolution: byte units, k = req_cap, coalesce ratio from the
    configured coalesce capacity)."""
    from repro_torch.core import cost_model as cm
    s = max(layout.stripe_size, 1)
    coalesce_ratio = 1.0
    if cfg.coalesce_cap and cfg.req_cap:
        # one local aggregator coalesces its whole group's request
        # lists (~n_ranks/n_nodes of them) down to <= coalesce_cap, so
        # the modeled k'/k accounts for the per-LA fan-in, not just one
        # rank's list
        group = max(n_ranks // max(n_nodes, 1), 1)
        coalesce_ratio = min(1.0,
                             cfg.coalesce_cap / (group * cfg.req_cap))
    return cm.Workload(
        P=n_ranks, nodes=n_nodes, P_G=n_aggregators,
        k=float(max(cfg.req_cap, 1)),
        total_bytes=float(max(layout.file_len, 1) * unit_bytes),
        stripe_size=float(s * unit_bytes),
        coalesce_ratio=coalesce_ratio,
        overlap=1.0 if cfg.pipeline else 0.0)


def resolve_method(workload, machine=None) -> str:
    """``method="auto"``: pick two-phase vs TAM for a workload by the
    modeled totals (``tam_cost`` at the optimal P_L vs
    ``twophase_cost``). Shared by :func:`compile_plan` and the host
    planner so the choice cannot drift between entry points."""
    from repro_torch.core import cost_model as cm
    machine = machine or cm.Machine()
    tam_best = cm.optimal_PL(workload, machine)[1]
    return ("tam" if tam_best.total < cm.twophase_cost(workload,
                                                       machine).total
            else "twophase")


def resolve_slow_hop_codec(workload, machine=None) -> str | None:
    """``slow_hop_codec="auto"``: enable the lossless byte codec when
    the modeled slow-hop saving beats the encode cost
    (``cost_model.slow_hop_codec_gain`` at the workload's measured
    ``slow_hop_ratio`` — the host path estimates it from the payload's
    zero fraction). Auto never picks a LOSSY codec: losing bits is a
    caller decision (``slow_hop_codec="ef-int8"`` explicitly), not a
    tuning knob. Shared by :func:`compile_plan` and the host planner."""
    from repro_torch.core import cost_model as cm
    machine = machine or cm.Machine()
    if workload.slow_hop_ratio <= 1.0:
        return None
    gain = cm.slow_hop_codec_gain(workload, machine)
    return "rle" if gain > 0.0 else None


def _legal_cb_candidates(domain_len: int, stripe: int, unit_bytes: int):
    """RoundScheduler-legal cb sizes in BYTES for the autotuner."""
    from repro_torch.core import cost_model as cm
    cands = tuple(c for c in cm.cb_candidates(domain_len, stripe)
                  if domain_len % c == 0 and (c % stripe == 0
                                              or stripe % c == 0))
    cands = cands or (domain_len,)
    return tuple(c * unit_bytes for c in cands)


def compile_plan(layout: FileLayout, cfg: IOConfig, *,
                 n_aggregators: int, n_nodes: int, n_ranks: int,
                 method: str = "twophase", direction: str = "write",
                 machine=None, workload=None,
                 unit_bytes: int = ELEM_BYTES, trace: bool = False):
    """Compile one collective-I/O schedule into an :class:`IOPlan` by
    running the pass pipeline of ``repro_torch.core.passes``.

    This is THE planner: both executors' entry points
    (``twophase.plan_for`` / ``tam`` wrappers and
    ``HostCollectiveIO.plan_for``) route through it, so all domain /
    stripe / window / round derivation lives here and nowhere else.
    Every knob resolution is one named, pure ``IOPlan -> IOPlan`` pass
    (normalize_layout -> resolve_codec -> resolve_method ->
    resolve_placement -> resolve_cb_and_depth -> coalesce_windows ->
    validate -> lower_kernels; see ``core/passes.py`` for why that
    order). The pipeline is deterministic — the session-cache-key
    contract (tests/test_plan_property.py).

    layout:        striped file layout. Units are the caller's (elements
                   on the SPMD side, bytes on the host side) — the plan
                   is unit-agnostic; ``unit_bytes`` converts to bytes
                   only where the cost model needs absolute sizes.
    n_aggregators: global aggregators (slow-axis size for SPMD,
                   stripe_count for the host path).
    method:        "twophase" | "tam" | "auto" — auto compares the
                   modeled totals (``tam_cost`` at the optimal P_L vs
                   ``twophase_cost``) for the workload and picks.
    workload:      optional measured ``cost_model.Workload`` driving
                   the auto resolutions; derived from cfg + layout when
                   absent.
    machine:       optional ``cost_model.Machine`` calibration.
    trace:         when True, return ``(plan, snapshots)`` where
                   ``snapshots`` is one ``(pass_name, plan)`` pair per
                   pass — diff adjacent snapshots with
                   :func:`plan_diff` (or ``passes.trace_report``) to
                   see exactly which pass rewrote which field.

    Raises ``ValueError`` for schedules violating the round-partition
    invariants (uneven domains, non-aligned cb) — compile time, not run
    time, is where a bad schedule should die.
    """
    from repro_torch.core import cost_model as cm
    from repro_torch.core import passes as passes_mod
    machine = machine or cm.Machine()
    w = workload if workload is not None else _default_workload(
        layout, cfg, n_aggregators, n_nodes, n_ranks, unit_bytes)
    ctx = passes_mod.PlanContext(cfg=cfg, workload=w, machine=machine,
                                 n_nodes=n_nodes, n_ranks=n_ranks,
                                 unit_bytes=unit_bytes)
    plan = passes_mod.initial_plan(layout, cfg,
                                   n_aggregators=n_aggregators,
                                   method=method, direction=direction)
    snapshots: list | None = [] if trace else None
    plan = passes_mod.run_passes(plan, ctx, trace=snapshots)
    return (plan, tuple(snapshots)) if trace else plan


def resolve_cb_buffer_size(layout: FileLayout, n_nodes: int, n_ranks: int,
                           cfg: IOConfig, machine=None) -> IOConfig:
    """Resolve ``cb_buffer_size == "auto"`` to concrete elements.

    Kept as the public PR-2 entry point; it is now a thin view over
    :func:`compile_plan`'s cb resolution (one aggregator per node)."""
    if cfg.cb_buffer_size != "auto":
        return cfg
    plan = compile_plan(layout, cfg, n_aggregators=n_nodes,
                        n_nodes=n_nodes, n_ranks=n_ranks,
                        machine=machine)
    return replace(cfg, cb_buffer_size=plan.cb)


def plan_from_fields(d: dict) -> IOPlan:
    """Build an :class:`IOPlan` from a plan's field dict.

    ``d`` has the form the reference's golden-plan serializer writes
    (``layout`` as ``[stripe_size, stripe_count, file_len]``, lists for
    ``axis_names`` and ``placement``), plus ``transport``; absent
    optional fields take the dataclass defaults. This is how a plan the
    reference planner compiled is carried into the port unchanged.
    """
    stripe_size, stripe_count, file_len = d["layout"]
    placement = d.get("placement")
    return IOPlan(
        layout=FileLayout(int(stripe_size), int(stripe_count),
                          int(file_len)),
        n_aggregators=int(d["n_aggregators"]), cb=d["cb"],
        n_rounds=int(d["n_rounds"]), method=d["method"],
        direction=d["direction"], pipeline_depth=d["pipeline_depth"],
        req_cap=int(d["req_cap"]), data_cap=int(d["data_cap"]),
        coalesce_cap=d.get("coalesce_cap"),
        axis_names=tuple(d["axis_names"]),
        tam_read_fallback=bool(d.get("tam_read_fallback", False)),
        slow_hop_codec=d.get("slow_hop_codec"),
        placement=None if placement is None else tuple(placement),
        kernel_fusion=d.get("kernel_fusion"),
        transport=d.get("transport"))
