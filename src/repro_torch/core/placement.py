"""Aggregator placement: WHERE each file domain's aggregator sits.

ROMIO's ``cb_config_list`` exists because the cost of a collective
write depends not only on how many aggregators there are but on which
physical ranks they land on relative to the data (Thakur et al.,
"Optimizing Noncontiguous Accesses in MPI-IO"); the hybrid intra-node
literature (Zhou et al.) makes the same point for process grouping.
This module makes that choice an explicit, planner-owned object: a
PERMUTATION ``perm`` of the aggregator slots, where ``perm[g]`` is the
slot that serves file domain ``g``.

Slots vs domains
----------------
A *slot* is a physical aggregator position. The canonical slot->node
map is packed blocks: slot ``s`` lives on node ``s * n_nodes // n_agg``
(:func:`node_of_slot`) — balanced to within one slot per node by
construction. A *domain* is a schedule object: aggregator domain ``g``
owns the domain-local span ``[g * domain_len, (g+1) * domain_len)``.
The placement permutes which slot serves which domain; it never changes
how many slots a node hosts (that is the canonical map's job), so every
placement is a pure bijection on the aggregator set — which is exactly
why every byte-identity harness extends to it: the bytes that land in
domain ``g`` are the same bytes, routed through a different slot.

Policies
--------
* ``"packed"`` — the identity: domain ``g`` on slot ``g``, i.e. every
  domain served on its *home* node (the node the canonical map puts
  slot ``g`` on). Optimal when writers exhibit locality (node n's ranks
  mostly write node n's domains — the fast-hop case the paper's
  intra-node aggregation exploits).
* ``"spread"`` — consecutive domains round-robin across nodes: the
  g-th domain goes to the g-th slot of the node-interleaved slot
  enumeration. Optimal when the *active* file region is a contiguous
  prefix (only some domains carry bytes): packed would concentrate the
  live aggregators on few nodes, spread balances them.
* ``"node_balanced"`` — greedy makespan balancing of MEASURED
  per-domain byte loads: domains in descending-bytes order each take a
  free slot on the currently least-loaded node. Uniform loads reduce it
  to a spread-like interleave; skewed loads are where it earns the
  name. Requires ``domain_bytes`` to differ from ``"spread"``.
* ``"auto"`` — evaluates every named policy with
  :func:`repro_torch.core.cost_model.placement_cost` (the fast-hop/slow-hop
  split plus the per-node makespan the placement induces) and picks the
  argmin — so auto is never modeled-worse than any named policy, and
  ties resolve to ``"packed"`` (the identity, the cheapest to execute).

An explicit tuple is also accepted anywhere a policy name is (the
session's measured re-resolution produces tuples; tests pass arbitrary
permutations). :func:`validate_placement` rejects non-bijections at
plan-compile time.
"""
from __future__ import annotations

PLACEMENT_POLICIES = ("packed", "spread", "node_balanced")


def node_of_slot(slot: int, n_aggregators: int, n_nodes: int) -> int:
    """Canonical slot->node map: packed, balanced to within one slot."""
    return slot * n_nodes // n_aggregators


def validate_placement(perm, n_aggregators: int) -> tuple[int, ...]:
    """Return ``perm`` as a tuple, or raise ``ValueError`` unless it is
    a bijection on ``range(n_aggregators)`` (the property every
    executor relies on: each slot serves exactly one domain)."""
    perm = tuple(int(p) for p in perm)
    if len(perm) != n_aggregators or sorted(perm) != list(
            range(n_aggregators)):
        raise ValueError(
            f"placement {perm!r} is not a permutation of "
            f"range({n_aggregators})")
    return perm


def is_identity(perm) -> bool:
    return perm is None or tuple(perm) == tuple(range(len(perm)))


def inverse_placement(perm) -> tuple[int, ...]:
    """``inv[slot] = domain`` for ``perm[domain] = slot``."""
    inv = [0] * len(perm)
    for g, s in enumerate(perm):
        inv[s] = g
    return tuple(inv)


def packed_placement(n_aggregators: int, n_nodes: int) -> tuple[int, ...]:
    return tuple(range(n_aggregators))


def spread_placement(n_aggregators: int, n_nodes: int) -> tuple[int, ...]:
    """Node-interleaved slot enumeration: consecutive domains land on
    different nodes (first slot of each node, then second of each...)."""
    by_node: list[list[int]] = [[] for _ in range(max(n_nodes, 1))]
    for s in range(n_aggregators):
        by_node[node_of_slot(s, n_aggregators, n_nodes)].append(s)
    order: list[int] = []
    depth = 0
    while len(order) < n_aggregators:
        for slots in by_node:
            if depth < len(slots):
                order.append(slots[depth])
        depth += 1
    return tuple(order)


def node_balanced_placement(n_aggregators: int, n_nodes: int,
                            domain_bytes=None,
                            node_slowdown=None) -> tuple[int, ...]:
    """Greedy per-node makespan balancing of the measured domain loads:
    heaviest domain first, each onto a free slot of the least-loaded
    node (node order breaks ties deterministically). ``node_slowdown``
    (per-node factors >= 1, the executor's measured feedback) scales a
    node's accrued load — a straggler fills up ``factor`` times faster,
    so the greedy argmin naturally steers the heavy domains off it
    while this stays a pure bijection (every slot still serves exactly
    one domain; only the domain->node MATCHING changes)."""
    if domain_bytes is None:
        domain_bytes = [1.0] * n_aggregators
    slow = [max(float(s), 1.0) for s in (node_slowdown or ())]
    slow += [1.0] * (max(n_nodes, 1) - len(slow))
    by_node: list[list[int]] = [[] for _ in range(max(n_nodes, 1))]
    for s in range(n_aggregators):
        by_node[node_of_slot(s, n_aggregators, n_nodes)].append(s)
    load = [0.0] * len(by_node)
    order = sorted(range(n_aggregators),
                   key=lambda g: (-float(domain_bytes[g]), g))
    perm = [0] * n_aggregators
    for g in order:
        db = float(domain_bytes[g])
        n = min((i for i in range(len(by_node)) if by_node[i]),
                key=lambda i: (load[i] + db * slow[i], i))
        perm[g] = by_node[n].pop(0)
        load[n] += db * slow[n]
    return tuple(perm)


_POLICY_FNS = {
    "packed": packed_placement,
    "spread": spread_placement,
    "node_balanced": node_balanced_placement,
}


def resolve_placement(spec, n_aggregators: int, n_nodes: int, *,
                      workload=None, machine=None, domain_bytes=None,
                      node_bytes=None,
                      node_slowdown=None) -> tuple[int, ...] | None:
    """Resolve a placement spec to a concrete permutation (or ``None``).

    spec: ``None`` (placement off — executors keep the legacy
    identity path), a policy name, ``"auto"``, or an explicit
    permutation. ``"auto"`` scores every named policy with
    ``cost_model.placement_cost`` for the (measured or assumed)
    workload — ``node_bytes`` is the session's measured per-(domain,
    sender-node) byte matrix, ``domain_bytes`` the per-domain loads —
    and returns the argmin; with no workload at all it falls back to
    ``"packed"`` (the identity: safe, and modeled-tied with everything
    under the uniform default anyway). ``node_slowdown`` (measured
    per-node factors, ``IOTimings.node_slowdown``) biases both the
    balanced policy's greedy and the auto scoring so a straggling node
    sheds aggregator load — the bijective half of degraded placement
    (the non-bijective half, slot evacuation, lives in
    ``core.faults.evacuation_map`` and stays out of the plan)."""
    if spec is None:
        return None
    if not isinstance(spec, str):
        return validate_placement(spec, n_aggregators)
    if node_bytes is not None and domain_bytes is None:
        # measured matrix implies the per-domain loads — named policies
        # (node_balanced) consume them too, not just "auto"
        domain_bytes = [sum(row) for row in node_bytes]
    if spec in _POLICY_FNS:
        if spec == "node_balanced":
            return validate_placement(
                node_balanced_placement(n_aggregators, n_nodes,
                                        domain_bytes, node_slowdown),
                n_aggregators)
        return validate_placement(_POLICY_FNS[spec](n_aggregators,
                                                    n_nodes),
                                  n_aggregators)
    if spec != "auto":
        raise ValueError(
            f"unknown placement {spec!r} (policies: "
            f"{PLACEMENT_POLICIES + ('auto',)} or an explicit "
            "permutation)")
    if workload is None:
        return packed_placement(n_aggregators, n_nodes)
    from repro_torch.core import cost_model as cm
    machine = machine or cm.Machine()
    best_perm, best_cost = None, None
    for name in PLACEMENT_POLICIES:
        perm = (_POLICY_FNS[name](n_aggregators, n_nodes, domain_bytes,
                                  node_slowdown)
                if name == "node_balanced"
                else _POLICY_FNS[name](n_aggregators, n_nodes))
        cost = cm.placement_cost(workload, machine, perm, n_nodes,
                                 domain_bytes=domain_bytes,
                                 node_bytes=node_bytes,
                                 node_slowdown=node_slowdown)
        if best_cost is None or cost < best_cost - 1e-15:
            best_perm, best_cost = perm, cost
    return validate_placement(best_perm, n_aggregators)
