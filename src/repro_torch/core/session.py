"""Persistent collective-I/O sessions: plan reuse + measured feedback
(port of ``repro.core.session``).

Production checkpoint loops repeat the SAME I/O pattern hundreds of
times, yet the planner re-paid the expensive part of every write —
measuring the workload (an O(total_bytes) zero scan when a codec is
weighed), sweeping the cb candidates, re-deriving the topology — on
every call. An :class:`IOSession` is the cross-write memory that
amortizes it:

* **Plan cache.** Compiled :class:`~repro_torch.core.plan.IOPlan`\\ s are
  cached under a key derived from (layout, config): the writer's shape
  (ranks, nodes, striping), the request set's fingerprint (extent,
  total bytes, request count), and every requested knob *as requested*
  (``"auto"`` included). An identical write is a cache hit — the plan
  is reused as-is, planning cost ~0. A changed layout or config is a
  different key and compiles fresh. The cache-key contract is exactly
  plan determinism: ``compile_plan`` is a pure function of its inputs
  (the planner's property), so a cached plan
  IS the plan a recompile would produce.

* **Measured feedback.** After each write the session ingests the
  executor's measurements (:class:`IOTimings`): executed rounds, the
  per-round comm/drain arrays, the achieved slow-hop compression
  ratio, and the per-(domain, sender-node) byte matrix. On the next
  write of the same key, every knob the caller left ``"auto"`` is
  re-resolved against the MEASUREMENT instead of the model's
  assumptions — ``rounds_override`` for cb, ``optimal_depth`` over the
  measured round times, ``resolve_slow_hop_codec`` at the measured
  ratio, ``resolve_placement`` over the measured node-byte matrix —
  the ``Workload.rounds_override`` measured-beats-assumed pattern
  promoted to a cross-write loop.

* **Replan only when it pays.** A re-resolution that produces new
  knobs runs ONCE as a trial; from then on every write executes the
  best plan BY MEASURED TOTAL seen so far (ties keep the incumbent).
  The executed total is the final arbiter, so the steady state is
  monotone: it never runs a plan that measured worse than the first
  write's (asserted by tests/test_torch_session.py).

``HostCollectiveIO(session=...)`` / ``write(session=...)`` consume
this; the rank-axis side can use
:meth:`IOSession.compile` as a caching front-end to ``compile_plan``.

Reads drive the same protocol (:meth:`IOSession.begin_read`, an alias
— the state machine is key-generic): ``HostCollectiveIO.read`` keys
its entries on the READER's shape, the manifest fingerprint, the
node-cache flag, and the requested knobs, and feeds the read
executor's measured totals back through the same arbiter. The
steady-state guarantee carries over verbatim: a repeated restore never
executes a plan that measured worse than its first restore's.
"""
from __future__ import annotations

import functools
import threading
from dataclasses import dataclass, field

from repro_torch.core import cost_model as cm
from repro_torch.core import faults as faults_mod
from repro_torch.core import placement as placement_mod
from repro_torch.core.plan import (IOPlan, compile_plan, resolve_method,
                                   resolve_slow_hop_codec)


def _knobs_of(plan: IOPlan) -> tuple:
    """The tuning-relevant fingerprint of a compiled plan (what a
    refinement can change; two plans with equal knobs execute — and
    therefore measure — identically, the model being deterministic)."""
    return (plan.method, plan.cb, plan.pipeline_depth,
            plan.slow_hop_codec, plan.placement)


def _arb_key(plan: IOPlan, serve_map) -> tuple:
    """The arbiter key: the plan's knobs PLUS the execution-level serve
    map (a degraded evacuation is a distinct thing-to-measure even when
    the compiled plan is unchanged — core.faults.evacuation_map)."""
    return _knobs_of(plan) + (tuple(serve_map) if serve_map is not None
                              else None,)


def _locked(fn):
    """Serialize a session method on the instance's re-entrant lock —
    the async checkpoint drain thread and the foreground caller share
    one session (see the class docstring's thread-safety note)."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)
    return wrapper


#: "no measurement ingested yet" sentinel for _Entry.executor — None is
#: a real identity (the in-process executors), so it cannot serve
_UNOBSERVED: object = object()


@dataclass
class _Entry:
    plan: IOPlan                      # first-compiled plan
    requested: dict                   # knobs as the caller spelled them
    workload: object | None           # measured cost_model.Workload
    cb_candidates: tuple = ()
    P_L: int | None = None
    n_nodes: int = 1
    n_aggregators: int = 1
    plans: dict = field(default_factory=dict)    # arb key -> IOPlan
    serve_maps: dict = field(default_factory=dict)  # arb key -> serve map
    totals: dict = field(default_factory=dict)   # arb key -> measured total
    best_knobs: tuple | None = None
    feedback: dict = field(default_factory=dict)
    executor: object = _UNOBSERVED    # IOTimings.transport of the totals
    writes: int = 0
    refined: bool = False

    def best_plan(self) -> IOPlan:
        if self.best_knobs is not None and self.best_knobs in self.plans:
            return self.plans[self.best_knobs]
        return self.plan

    def best_serve_map(self):
        if self.best_knobs is not None:
            return self.serve_maps.get(self.best_knobs)
        return None


class IOSession:
    """Cross-write plan cache + measured-feedback tuner (see module
    docstring). One session serves any number of distinct workloads —
    each (layout, config) key gets its own entry — so a single session
    can back a whole checkpoint manager.

    Thread safety: every protocol step (begin/register/observe/abort/
    compile) takes the session's re-entrant lock, so an ASYNC
    checkpoint drain (checkpoint.PendingCheckpoint's daemon thread)
    can feed measured timings back through :meth:`observe` without
    corrupting an entry a foreground caller is reading. Trial
    ORDERING is the caller's contract: ``CheckpointManager`` keeps at
    most one write in flight, so a background drain's feedback never
    interleaves with a foreground trial of the same key mid-protocol.
    """

    def __init__(self, machine=None):
        self.machine = machine or cm.Machine()
        self._entries: dict = {}
        self._compiled: dict = {}     # compile() front-end cache
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.replans = 0

    # ------------------------------------------------------------------
    # generic plan-compile cache (the SPMD-side entry point)
    # ------------------------------------------------------------------
    @_locked
    def compile(self, layout, cfg, **kwargs) -> IOPlan:
        """Caching front-end to :func:`repro_torch.core.plan.compile_plan`:
        identical (layout, cfg, kwargs) return the SAME plan object
        without recompiling — sound because ``compile_plan`` is
        deterministic (the session-cache-key contract,
        the planner's property)."""
        key = (layout, cfg, tuple(sorted(
            (k, v if not isinstance(v, list) else tuple(v))
            for k, v in kwargs.items() if k not in ("machine", "workload"))))
        extra = {k: kwargs[k] for k in ("machine", "workload")
                 if k in kwargs}
        if extra:     # unhashable inputs: compile through, no caching
            return compile_plan(layout, cfg, **kwargs)
        if key in self._compiled:
            self.hits += 1
            return self._compiled[key]
        self.misses += 1
        plan = compile_plan(layout, cfg, **kwargs)
        self._compiled[key] = plan
        return plan

    # ------------------------------------------------------------------
    # the write-path protocol (HostCollectiveIO.write drives this)
    # ------------------------------------------------------------------
    @_locked
    def begin_write(self, key, machine=None) -> tuple[str, object]:
        """Start a write under ``key``. Returns one of:

        * ``("miss", None)`` — no entry: compile a fresh plan and hand
          it back through :meth:`register`;
        * ``("trial", knobs_dict)`` — measured feedback re-resolved the
          ``"auto"`` knobs to something untried: compile a plan with
          these CONCRETE knobs (cheap — nothing left to sweep) and
          register it with :meth:`register_trial`. The dict's
          ``"serve_map"`` entry (usually ``None``) is the degraded
          evacuation map to execute the trial under;
        * ``("hit", (plan, serve_map))`` — reuse the best measured
          (plan, serve map) pair as-is.

        ``machine`` is the WRITER's calibration — refinements must
        resolve under the same machine the first write's autos did, not
        this session's default.

        Refinement normally runs ONCE per entry; :meth:`observe` re-arms
        it when the measured feedback materially changes (a node's
        service rate shifting — a straggler appearing or clearing), so
        a mid-session degradation triggers a fresh trial on the very
        next write instead of being locked out by the one-shot flag.
        """
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return "miss", None
        self.hits += 1
        if entry.feedback and not entry.refined:
            entry.refined = True
            knobs = self._refine(entry, machine or self.machine)
            if knobs is not None:
                tried = set(entry.totals) | {_arb_key(entry.plan, None)}
                serve = knobs.get("serve_map")
                as_tuple = (knobs["method"], knobs["cb_bytes"],
                            knobs["pipeline_depth"],
                            knobs["slow_hop_codec"], knobs["placement"],
                            tuple(serve) if serve is not None else None)
                if as_tuple not in tried:
                    self.replans += 1
                    return "trial", knobs
        return "hit", (entry.best_plan(), entry.best_serve_map())

    # The protocol is key-generic: nothing in begin/register/observe is
    # write-specific, so the read path (HostCollectiveIO.read) drives
    # the SAME state machine under read-marked keys — reads lead their
    # key with a "read" tag plus the node-cache flag, so a read entry
    # never collides with a write of the same shape. ``begin_read`` is
    # the read-path spelling of that reuse.
    begin_read = begin_write

    @_locked
    def register(self, key, plan: IOPlan, *, requested: dict,
                 workload=None, cb_candidates=(), P_L=None,
                 n_nodes: int = 1, n_aggregators: int = 1) -> None:
        """Record the first-compiled plan for ``key`` (the miss path).
        ``workload`` is the measured ``cost_model.Workload`` the autos
        resolved against — stored so refinements never re-pay the
        measurement."""
        self._entries[key] = _Entry(
            plan=plan, requested=dict(requested), workload=workload,
            cb_candidates=tuple(cb_candidates), P_L=P_L,
            n_nodes=n_nodes, n_aggregators=n_aggregators)
        self._entries[key].plans[_arb_key(plan, None)] = plan

    @_locked
    def register_trial(self, key, plan: IOPlan, serve_map=None) -> None:
        entry = self._entries[key]
        ak = _arb_key(plan, serve_map)
        entry.plans[ak] = plan
        if serve_map is not None:
            entry.serve_maps[ak] = tuple(serve_map)

    @_locked
    def abort(self, key, plan: IOPlan | None = None) -> None:
        """A write under ``key`` raised before :meth:`observe` ran.
        Revert the trial bookkeeping so the entry is not poisoned: every
        registered plan with NO measured total (the half-registered
        trial) is dropped, and the one-shot refinement flag is re-armed
        so the next write may re-trial. Without this, an aborted trial
        left the entry holding knobs that would never be measured and
        never retried — silently freezing the tuner."""
        entry = self._entries.get(key)
        if entry is None:
            return
        first = _arb_key(entry.plan, None)
        stale = [ak for ak in entry.plans
                 if ak not in entry.totals and ak != first]
        if plan is not None:
            stale = [ak for ak in stale if entry.plans[ak] is plan
                     or ak[:5] == _knobs_of(plan)]
        for ak in stale:
            entry.plans.pop(ak, None)
            entry.serve_maps.pop(ak, None)
        entry.refined = False

    @_locked
    def observe(self, key, plan: IOPlan, timings, serve_map=None) -> None:
        """Feed one write's measurements back: the executed total
        decides the incumbent (strictly-better wins, ties keep), and
        the per-round arrays / ratio / node-byte matrix / per-node
        slowdown become the next refinement's inputs. A material shift
        in the measured per-node service rates (straggler appearing or
        clearing) re-arms the one-shot refinement flag."""
        entry = self._entries.get(key)
        if entry is None:
            return
        entry.writes += 1
        # measured totals are executor-relative: the in-process
        # executors report MODELED time, the mp transport reports
        # wall-clock. If the backend that produced this measurement
        # differs from the one whose totals the entry holds, the stored
        # numbers are incomparable with the new one — arbitrating
        # across them would crown a plan on the wrong clock. Drop them
        # and start the arbiter fresh on the new executor's scale.
        ident = getattr(timings, "transport", None)
        if entry.executor is not _UNOBSERVED and entry.executor != ident:
            entry.totals.clear()
            entry.best_knobs = None
        entry.executor = ident
        ak = _arb_key(plan, serve_map)
        entry.plans.setdefault(ak, plan)
        if serve_map is not None:
            entry.serve_maps[ak] = tuple(serve_map)
        entry.totals[ak] = float(timings.total)
        if entry.best_knobs is None:
            entry.best_knobs = ak
        else:
            # re-elect the argmin (not just promote strictly-better
            # newcomers): re-measuring the INCUMBENT under a degraded
            # machine overwrites its total in place, and the crown must
            # move to whatever now measures best. Ties keep the
            # earliest-measured plan (insertion order), preserving the
            # healthy-path tie-to-incumbent semantics.
            best = entry.best_knobs
            for k2, v in entry.totals.items():
                if v < entry.totals[best] - 1e-15:
                    best = k2
            entry.best_knobs = best
        fb = entry.feedback
        fb["rounds"] = int(getattr(timings, "rounds_executed", 1))
        if getattr(timings, "comm_rounds", ()):
            fb["round_times"] = (tuple(timings.comm_rounds),
                                 tuple(timings.io_rounds))
        if getattr(timings, "slow_hop_codec", None) is not None:
            fb["ratio"] = float(timings.slow_hop_compression_ratio)
        if getattr(timings, "node_bytes", ()):
            fb["node_bytes"] = tuple(tuple(row)
                                     for row in timings.node_bytes)
        new_sd = tuple(float(s) for s in
                       getattr(timings, "node_slowdown", ()) or ())
        if new_sd:
            old_sd = fb.get("node_slowdown")
            fb["node_slowdown"] = new_sd
            changed = (any(abs(a - b) > 0.25
                           for a, b in zip(new_sd, old_sd))
                       if old_sd is not None
                       else max(new_sd) > 1.25)
            if changed:
                entry.refined = False   # re-arm: the machine moved

    @_locked
    def entry(self, key) -> _Entry | None:
        return self._entries.get(key)

    # ------------------------------------------------------------------
    def _refine(self, entry: _Entry, machine=None) -> dict | None:
        """Re-resolve the requested ``"auto"`` knobs against the
        measurement (measured-beats-assumed, across writes). Returns a
        concrete knob dict, or ``None`` when nothing was auto or no
        measurement informs a change."""
        req = entry.requested
        autos = [k for k in ("method", "cb_bytes", "pipeline_depth",
                             "slow_hop_codec", "placement")
                 if req.get(k) == "auto"]
        if not autos or entry.workload is None:
            return None
        m = machine or self.machine
        fb = entry.feedback
        base = entry.best_plan()
        w = cm.with_measured_rounds(entry.workload,
                                    fb.get("rounds", base.n_rounds))
        if "ratio" in fb and base.slow_hop_codec is not None:
            # the achieved wire ratio replaces the zero-scan estimate
            w = cm.with_codec(w, max(fb["ratio"], 1.0))

        codec = base.slow_hop_codec
        if "slow_hop_codec" in autos:
            codec = resolve_slow_hop_codec(w, m)
        method = base.method
        if "method" in autos:
            method = resolve_method(w, m)
        P_L = entry.P_L if method == "tam" else None
        cb = base.cb
        if "cb_bytes" in autos and entry.cb_candidates:
            cb, _ = cm.optimal_cb(w, m, P_L=P_L,
                                  candidates=entry.cb_candidates)
        depth = base.pipeline_depth
        if "pipeline_depth" in autos and "round_times" in fb:
            depth, _ = cm.optimal_depth(round_times=fb["round_times"])
        placement = base.placement
        sd = fb.get("node_slowdown")
        serve_map = None
        if "placement" in autos and ("node_bytes" in fb
                                     or sd is not None):
            placement = placement_mod.resolve_placement(
                "auto", entry.n_aggregators, entry.n_nodes, workload=w,
                machine=m, node_bytes=fb.get("node_bytes"),
                node_slowdown=sd)
            # degraded half: past the straggler threshold a bijection
            # cannot unload the node (it still serves its slot count),
            # so resolve an execution-level evacuation map on top —
            # overflow domains serialize on healthy slots, the
            # straggler's slots go idle (core.faults; the plan and its
            # SPMD identity stay bijective)
            if sd is not None:
                db = ([sum(row) for row in fb["node_bytes"]]
                      if "node_bytes" in fb else None)
                serve_map = faults_mod.evacuation_map(
                    entry.n_aggregators, entry.n_nodes, sd,
                    domain_bytes=db)
        return {"method": method, "cb_bytes": cb,
                "pipeline_depth": depth, "slow_hop_codec": codec,
                "placement": placement, "serve_map": serve_map}
