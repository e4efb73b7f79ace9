"""Planner pass pipeline: named, pure ``IOPlan -> IOPlan`` rewrites.

``compile_plan`` used to be one monolithic function interleaving five
"auto" resolutions (method, cb, depth, codec, placement — PRs 3-5).
Following ROMIO's separation of access-pattern analysis from data
movement (Thakur et al.), planning is now a *pipeline*: an initial plan
carrying the knobs exactly as the caller spelled them ("auto" included)
is pushed through an ordered registry of passes, each a named, pure
rewrite of one concern. ``compile_plan(trace=True)`` returns the
per-pass snapshots so adjacent plans are diffable with
:func:`repro_torch.core.plan.plan_diff` — a bad rewrite names the pass and
the field it broke.

Registered order (semantic, not alphabetical — the codec's wire
discount feeds every later auto through the effective workload):

    normalize_layout     validate direction + even domain split
    resolve_codec        "auto" -> cost-model codec pick; typo dies
    resolve_method       "auto" -> twophase|tam; tam_read_fallback
    resolve_placement    policy/"auto" -> permutation; bijection check
    resolve_cb_and_depth joint cb x depth autotune (cost model)
    coalesce_windows     materialize cb (None -> domain) + n_rounds
    validate             RoundScheduler invariants; no "auto" survives
    lower_kernels        pick the fused round kernel (or none)
    resolve_transport    pick the byte-moving backend (mp or in-proc)

Purity contract: a pass reads ``(plan, ctx)`` and returns a NEW plan —
no hidden state, no mutation of ``ctx``. The workload adjustment the
codec used to apply in-place is now the pure derivation
:func:`effective_workload`, recomputed by every downstream pass from
the plan's resolved codec field. Every pass is idempotent (property-
tested in tests/test_plan_property.py): running the pipeline on its own
output is the identity, which is what makes per-pass snapshots honest
intermediate states of ONE rewrite system.

Adding a pass: see ARCHITECTURE.md ("adding a planner pass") — define
it here with ``@register_pass("name")`` in registry order, keep it pure
and idempotent, and extend the idempotence property test.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

from repro_torch.core.domains import FileLayout


@dataclass(frozen=True)
class PlanContext:
    """Read-only inputs the passes resolve against (everything that is
    not plan state): the requested config, the cost-model workload as
    supplied/derived (UNADJUSTED — passes derive the codec-discounted
    view via :func:`effective_workload`), the machine calibration, and
    the writer shape."""

    cfg: object                  # IOConfig
    workload: object             # cost_model.Workload (pre-codec)
    machine: object              # cost_model.Machine
    n_nodes: int
    n_ranks: int
    unit_bytes: int


@dataclass(frozen=True)
class Pass:
    name: str
    fn: Callable
    doc: str = ""


PASS_REGISTRY: dict[str, Pass] = {}
_ORDER: list[Pass] = []


def register_pass(name: str):
    """Register a pass in pipeline order (declaration order == run
    order). The function must be a pure ``(plan, ctx) -> plan``."""
    def deco(fn):
        p = Pass(name=name, fn=fn, doc=(fn.__doc__ or "").strip())
        PASS_REGISTRY[name] = p
        _ORDER.append(p)
        return fn
    return deco


def effective_workload(w, slow_hop_codec, machine):
    """The workload view downstream autos resolve against, derived
    purely from the resolved codec field (the pre-pipeline planner
    mutated ``w`` in place at codec-resolution time; same semantics):

    * codec ON and the workload has no measured wire ratio and the
      codec is lossy -> charge the codec's modeled ratio;
    * codec OFF but the workload carries a measured ratio -> strip the
      discount (no codec, no saving, no encode cost);
    * otherwise the workload passes through untouched.
    """
    from repro_torch.core import codec as codec_mod
    from repro_torch.core import cost_model as cm
    if slow_hop_codec is not None:
        c = codec_mod.get_codec(slow_hop_codec)
        if w.slow_hop_ratio == 1.0 and not c.lossless:
            return cm.with_codec(w, c.modeled_ratio(0.0, w.total_bytes))
    elif w.slow_hop_ratio != 1.0:
        return cm.with_codec(w, 1.0)
    return w


# ---------------------------------------------------------------------------
# the passes, in registry (== run) order
# ---------------------------------------------------------------------------

@register_pass("normalize_layout")
def normalize_layout(plan, ctx):
    """Validate the schedule's frame: a known direction and a file that
    splits evenly into aggregator domains. Compile time — not run time
    — is where a bad schedule dies."""
    if plan.direction not in ("write", "read"):
        raise ValueError(f"unknown direction {plan.direction!r}")
    if plan.layout.file_len % plan.n_aggregators:
        raise ValueError("file_len must divide evenly among aggregators")
    return plan


@register_pass("resolve_codec")
def resolve_codec(plan, ctx):
    """Resolve the slow-hop wire codec. Runs FIRST among the autos: its
    beta discount / encode cost feed method, placement, cb, and depth
    through :func:`effective_workload`. ``"auto"`` never picks a lossy
    codec (losing bits is a caller decision, not a tuning knob)."""
    from repro_torch.core import codec as codec_mod
    from repro_torch.core.plan import resolve_slow_hop_codec
    codec = plan.slow_hop_codec
    if codec == "auto":
        codec = resolve_slow_hop_codec(ctx.workload, ctx.machine)
    if codec is not None:
        codec_mod.get_codec(codec)               # typo dies here
    return replace(plan, slow_hop_codec=codec)


@register_pass("resolve_method")
def resolve_method_pass(plan, ctx):
    """Resolve the aggregation topology: ``"auto"`` compares the
    modeled totals (``tam_cost`` at the optimal P_L vs
    ``twophase_cost``) for the codec-adjusted workload. Records the
    TAM-read lowering explicitly (``tam_read_fallback``) instead of
    silently aliasing the two-phase read path."""
    from repro_torch.core.plan import resolve_method
    method = plan.method
    if method == "auto":
        w = effective_workload(ctx.workload, plan.slow_hop_codec,
                               ctx.machine)
        method = resolve_method(w, ctx.machine)
    if method not in ("twophase", "tam"):
        raise ValueError(f"unknown method {method!r}")
    fallback = method == "tam" and plan.direction == "read"
    return replace(plan, method=method, tam_read_fallback=fallback)


@register_pass("resolve_placement")
def resolve_placement_pass(plan, ctx):
    """Resolve the aggregator placement from the same workload view the
    other autos see; an explicit permutation is validated here (a
    non-bijection is a bad schedule and dies at compile time like any
    other)."""
    from repro_torch.core import placement as placement_mod
    w = effective_workload(ctx.workload, plan.slow_hop_codec, ctx.machine)
    placement = placement_mod.resolve_placement(
        plan.placement, plan.n_aggregators, ctx.n_nodes, workload=w,
        machine=ctx.machine)
    return replace(plan, placement=placement)


@register_pass("resolve_cb_and_depth")
def resolve_cb_and_depth(plan, ctx):
    """Joint cb x depth resolution over the RoundScheduler-legal cb
    candidates (``optimal_cb_and_depth`` when both are "auto";
    ``optimal_cb`` / ``optimal_depth`` when only one is). A TAM plan
    autotunes at its optimal P_L. Read plans resolve against the read
    cost model (``read_cost`` — fetch + node-cache fan-out phases)
    instead of the write exchange. Leaves ``cb=None`` (single shot) for
    ``coalesce_windows`` to materialize."""
    from repro_torch.core import cost_model as cm
    from repro_torch.core.plan import _legal_cb_candidates
    cb, depth = plan.cb, plan.pipeline_depth
    if cb == "auto" or depth == "auto":
        w = effective_workload(ctx.workload, plan.slow_hop_codec,
                               ctx.machine)
        P_L_arg = None
        if plan.method == "tam":
            P_L_arg, _ = cm.optimal_PL(w, ctx.machine)
        cands = _legal_cb_candidates(plan.domain_len,
                                     plan.layout.stripe_size,
                                     ctx.unit_bytes)
        if plan.direction == "read":
            if cb == "auto" and depth == "auto":
                cb_bytes, depth, _ = cm.optimal_read_cb_and_depth(
                    w, ctx.machine, candidates=cands)
                cb = cb_bytes // ctx.unit_bytes
            elif cb == "auto":
                cb_bytes, _ = cm.optimal_read_cb(w, ctx.machine,
                                                 candidates=cands)
                cb = cb_bytes // ctx.unit_bytes
            else:  # depth == "auto" at a fixed cb
                cb_bytes = (cb if cb is not None
                            else plan.domain_len) * ctx.unit_bytes
                depth, _ = cm.optimal_read_depth(w, ctx.machine,
                                                 cb_bytes=cb_bytes)
        elif cb == "auto" and depth == "auto":
            cb_bytes, depth, _ = cm.optimal_cb_and_depth(
                w, ctx.machine, P_L=P_L_arg, candidates=cands)
            cb = cb_bytes // ctx.unit_bytes
        elif cb == "auto":
            cb_bytes, _ = cm.optimal_cb(w, ctx.machine, P_L=P_L_arg,
                                        candidates=cands)
            cb = cb_bytes // ctx.unit_bytes
        else:  # depth == "auto" at a fixed cb
            wc = cm.with_measured_rounds(
                w, cm.rounds_for_cb(w, (cb if cb is not None
                                        else plan.domain_len)
                                    * ctx.unit_bytes))
            depth, _ = cm.optimal_depth(wc, ctx.machine, P_L=P_L_arg)
    return replace(plan, cb=cb, pipeline_depth=max(1, int(depth)))


@register_pass("coalesce_windows")
def coalesce_windows(plan, ctx):
    """Materialize the round window schedule: ``cb=None`` becomes the
    whole domain (the single-shot schedule IS the 1-round plan) and
    ``n_rounds`` is derived from the final cb."""
    cb = plan.cb if plan.cb is not None else plan.domain_len
    return replace(plan, cb=cb, n_rounds=-(-plan.domain_len // cb))


@register_pass("validate")
def validate(plan, ctx):
    """Terminal schedule check: constructing the RoundScheduler IS the
    round-partition validation (uneven domains, non-aligned cb die
    here), and no ``"auto"`` may survive lowering."""
    from repro_torch.core.plan import RoundScheduler
    sched = RoundScheduler(plan.layout, plan.n_aggregators, plan.cb)
    for f in ("method", "cb", "pipeline_depth", "slow_hop_codec",
              "placement"):
        if getattr(plan, f) == "auto":
            raise ValueError(f"pass pipeline left {f}='auto' unresolved")
    assert sched.cb == plan.cb and sched.n_rounds == plan.n_rounds
    return plan


@register_pass("lower_kernels")
def lower_kernels(plan, ctx):
    """Pick the per-round kernel lowering. ``kernel_fusion="fused_round"``
    selects the fused drain kernel (``kernels.fused_round``: window sort
    + dual pack, two CUDA launches behind one call) for the write drain
    — one pass over the window where the unfused path pays three. The
    read direction and the codec kernels are not ported yet; the field
    is resolved exactly as the reference resolves it so plans match."""
    fusion = getattr(ctx.cfg, "kernel_fusion", None)
    if fusion not in (None, "fused_round"):
        raise ValueError(f"unknown kernel_fusion {fusion!r}")
    return replace(plan, kernel_fusion=fusion)


@register_pass("resolve_transport")
def resolve_transport(plan, ctx):
    """Pick the byte-moving backend. ``transport="mp"`` routes the
    executor dispatch in ``checkpoint.host_io`` to the multi-process
    backend (``checkpoint.mp_exec`` — forked workers, shared-memory
    intra-node fast hop, localhost-socket inter-node slow hop, measured
    wall-clock rounds); ``None`` keeps the in-process executors with
    modeled time. Validation lives in the one transport registry
    (``core.transport.resolve_transport``) — an unregistered name dies
    here, at plan time, not mid-write. Execution strategy, never
    routing: the schedule, placement, and bytes are transport-
    invariant (the rounds_checks cross-executor contract)."""
    from repro_torch.core.transport import resolve_transport as _resolve
    return replace(
        plan, transport=_resolve(getattr(ctx.cfg, "transport", None)))


PASSES: tuple[Pass, ...] = tuple(_ORDER)


def initial_plan(layout: FileLayout, cfg, *, n_aggregators: int,
                 method: str = "twophase", direction: str = "write"):
    """The pipeline's input: an IOPlan carrying every knob exactly as
    requested — ``"auto"`` strings, ``cb=None``, a placement policy
    name — with ``n_rounds=0`` as the not-yet-scheduled marker. Only
    the passes turn it into an executable schedule."""
    from repro_torch.core.plan import IOPlan
    return IOPlan(
        layout=layout, n_aggregators=n_aggregators,
        cb=cfg.cb_buffer_size, n_rounds=0, method=method,
        direction=direction,
        pipeline_depth=cfg.pipeline_depth if cfg.pipeline else 1,
        req_cap=cfg.req_cap, data_cap=cfg.data_cap,
        coalesce_cap=cfg.coalesce_cap, axis_names=cfg.axis_names,
        tam_read_fallback=False, slow_hop_codec=cfg.slow_hop_codec,
        placement=cfg.placement,
        kernel_fusion=getattr(cfg, "kernel_fusion", None),
        transport=getattr(cfg, "transport", None))


def run_passes(plan, ctx: PlanContext, passes: tuple = None,
               trace: list | None = None):
    """Run ``plan`` through ``passes`` (default: the full registry).
    When ``trace`` is a list, append one ``(pass_name, plan_snapshot)``
    per pass so callers can diff adjacent snapshots with
    :func:`repro_torch.core.plan.plan_diff`."""
    for p in (PASSES if passes is None else passes):
        plan = p.fn(plan, ctx)
        if trace is not None:
            trace.append((p.name, plan))
    return plan


def trace_report(trace) -> str:
    """Human-readable pipeline trace: for each pass, the fields it
    rewrote (``plan_diff`` of adjacent snapshots)."""
    from repro_torch.core.plan import plan_diff
    lines = []
    prev = None
    for name, snap in trace:
        if prev is None:
            lines.append(f"[{name}]")
        else:
            d = plan_diff(prev, snap)
            lines.append(f"[{name}] " + (d.replace("\n", "; ")
                                         if d else "(no change)"))
        prev = snap
    return "\n".join(lines)
