"""Rank-axis executor: runs a compiled :class:`IOPlan` (port of
``repro.core.spmd_exec``).

The reference lowers a plan to a ``shard_map`` program over the
``(node, lagg, lmem)`` device mesh. The port runs every rank on one
device: :class:`RankMesh` stands in for the ``jax.sharding.Mesh`` (it
has ``.shape[axis]`` and ``.size``, so the planner calls read as they
do in the reference), and the inputs are the reference's global arrays
— ``offsets``/``lengths [P, req_cap]``, ``count [P]``,
``data [P, data_cap]``, rank p = ``(node, lagg, lmem)`` row-major, the
order of ``P((node, lagg, lmem))`` on dim 0.

* ``method="twophase"`` — every rank routes each window's requests
  straight to the owning global aggregator and the window merges with a
  masked max over the node's ranks.
* ``method="tam"`` — both aggregation layers run inside the window loop
  (``rounds.exchange_rounds_write_tam``), once per ``(node, lagg)``
  group.
* ``direction="read"`` — aggregators broadcast one cb window per round
  and every rank gathers its own elements
  (``rounds.exchange_rounds_read``); TAM reads run the same schedule
  (``IOPlan.tam_read_fallback``).

The executor returns what the reference's does: the file as
``[n_aggregators, domain_len]`` and a stats dict of int32 tensors
(``dropped_requests``, ``dropped_elems``, ``requests_at_ga`` and, for
TAM, ``requests_before_coalesce`` / ``requests_after_coalesce``), equal
to the reference's values — including its division of the
lmem-replicated TAM counts by the lmem size.

The plan's slow-hop codec wraps the node-axis hop of every schedule
and direction (``rounds._codec_hooks``). Entry points run on the card
unless ``device="cpu"`` is passed; without a card they raise.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._device import resolve_device
from repro_torch.core import coalesce as co
from repro_torch.core import rounds
from repro_torch.core.plan import IOPlan, compile_plan
from repro_torch.core.requests import RequestList, mask_invalid


class RankMesh(NamedTuple):
    """The ``(node, lagg, lmem)`` rank grid that a ``jax.sharding.Mesh``
    describes in the reference, with no devices behind it."""

    node: int
    lagg: int
    lmem: int
    axis_names: tuple[str, str, str] = ("node", "lagg", "lmem")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, (self.node, self.lagg, self.lmem)))

    @property
    def size(self) -> int:
        return self.node * self.lagg * self.lmem

    @property
    def dims(self) -> tuple[int, int, int]:
        return (self.node, self.lagg, self.lmem)


def _as_requests(offsets, lengths, count, n_ranks: int) -> RequestList:
    return mask_invalid(RequestList(offsets.reshape(n_ranks, -1),
                                    lengths.reshape(n_ranks, -1),
                                    count.reshape(n_ranks)))


def _write(plan: IOPlan, dims, use_kernels: bool, offsets, lengths, count,
           data):
    n_ranks = dims[0] * dims[1] * dims[2]
    r = _as_requests(offsets, lengths, count, n_ranks)
    data = data.reshape(n_ranks, -1)
    starts = co.request_starts(r)
    sched = plan.scheduler()

    if plan.method == "tam":
        shard, st = rounds.exchange_rounds_write_tam(
            sched, dims, r, starts, data,
            coalesce_cap=plan.coalesce_cap, use_kernels=use_kernels,
            depth=plan.pipeline_depth,
            slow_hop_codec=plan.slow_hop_codec,
            placement=plan.placement,
            kernel_fusion=plan.kernel_fusion)
        n_lmem = dims[2]
        total = lambda x: x.sum(dtype=torch.int32)  # noqa: E731
        # the reference psums lmem-replicated group values over every
        # axis (or over node and lagg) and divides by the lmem size
        stats = {
            "dropped_requests": total(st["dropped_requests_rank"])
            + total(st["dropped_requests_agg"]),
            "dropped_elems": total(st["dropped_elems_rank"])
            + total(st["dropped_elems_agg"]),
            "requests_before_coalesce":
                total(st["requests_before_coalesce"]) // n_lmem,
            "requests_after_coalesce":
                total(st["requests_after_coalesce"]) // n_lmem,
            "requests_at_ga": st["requests_at_ga"],
        }
        return shard, stats

    shard, st = rounds.exchange_rounds_write(
        sched, dims, r, starts, data,
        depth=plan.pipeline_depth,
        slow_hop_codec=plan.slow_hop_codec,
        placement=plan.placement,
        kernel_fusion=plan.kernel_fusion)
    stats = {
        "dropped_requests": st["dropped_requests"].sum(dtype=torch.int32),
        "dropped_elems": st["dropped_elems"].sum(dtype=torch.int32),
        "requests_at_ga": st["requests_at_ga"],
    }
    return shard, stats


def _read(plan: IOPlan, n_ranks: int, offsets, lengths, count,
          file_shard):
    r = _as_requests(offsets, lengths, count, n_ranks)
    return rounds.exchange_rounds_read(
        plan.scheduler(), r, co.request_starts(r),
        file_shard.reshape(plan.n_aggregators, -1), plan.data_cap,
        depth=plan.pipeline_depth, slow_hop_codec=plan.slow_hop_codec,
        placement=plan.placement, kernel_fusion=plan.kernel_fusion)


def make_spmd_executor(mesh: RankMesh, plan: IOPlan,
                       use_kernels: bool = False, device=None):
    """Bind an :class:`IOPlan` to a rank mesh and a device.

    Write plans return ``fn(offsets, lengths, count, data) -> (file
    [n_aggregators, domain_len], stats)``; read plans return
    ``fn(offsets, lengths, count, file_shard [n_aggregators,
    domain_len]) -> payloads [P, data_cap]``. Inputs are moved to the
    executor's device (the card unless ``device="cpu"``). The mesh's
    node-axis size must match the plan's aggregator count.
    """
    node = plan.axis_names[0]
    if mesh.shape[node] != plan.n_aggregators:
        raise ValueError(
            f"plan compiled for {plan.n_aggregators} aggregators but mesh "
            f"axis {node!r} has size {mesh.shape[node]}")
    dev = resolve_device(device)
    dims = mesh.dims

    def run(offsets, lengths, count, data):
        args = [torch.as_tensor(x, device=dev)
                for x in (offsets, lengths, count, data)]
        args[:3] = [a.to(torch.int32) for a in args[:3]]
        with torch.no_grad():
            if plan.direction == "read":
                return _read(plan, mesh.size, *args)
            return _write(plan, dims, use_kernels, *args)

    run.plan = plan
    return run


def make_collective_write(mesh: RankMesh, layout, cfg, method: str = "auto",
                          use_kernels: bool = False, machine=None,
                          workload=None, device=None):
    """Plan + bind in one call, with ``method="auto"`` picking two-phase
    vs TAM per workload via the cost model at plan time."""
    node = cfg.axis_names[0]
    plan = compile_plan(layout, cfg, n_aggregators=mesh.shape[node],
                        n_nodes=mesh.shape[node], n_ranks=mesh.size,
                        method=method, machine=machine, workload=workload)
    return make_spmd_executor(mesh, plan, use_kernels=use_kernels,
                              device=device)
