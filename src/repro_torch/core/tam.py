"""TAM — the two-layer aggregation method, the paper's contribution
(port of ``repro.core.tam``).

Collective write in three steps:

1. **Intra-node aggregation** (``lmem``): the ranks of each
   local-aggregator group ship requests + payload to the group's local
   aggregator, which merge-sorts the offset-length pairs, coalesces
   contiguous runs, and repacks payloads so each run is one contiguous
   span (the ``bitonic_sort`` and ``coalesce`` kernels with
   ``use_kernels=True``).
2. **Inter-node aggregation** (``node``): only the coalesced metadata
   and repacked payload cross to the owning global aggregator.
3. **I/O step**: as two-phase — the global aggregator sorts and packs
   its contiguous file domain (the fused drain kernel with
   ``kernel_fusion="fused_round"``).

A thin wrapper over ``compile_plan(method="tam")`` and the rank-axis
executor, whose round loop runs both layers inside each cb window.
"""
from __future__ import annotations

from repro_torch.core.domains import FileLayout
from repro_torch.core.spmd_exec import RankMesh, make_spmd_executor
from repro_torch.core.twophase import IOConfig, plan_for


def make_tam_write(mesh: RankMesh, layout: FileLayout, cfg: IOConfig,
                   use_kernels: bool = False, device=None):
    """Build the TAM collective write: same signature and outputs as
    :func:`repro_torch.core.twophase.make_twophase_write`, with
    P_L = node * lagg local aggregators. Runs on the card unless
    ``device="cpu"``."""
    node = cfg.axis_names[0]
    plan = plan_for(layout, cfg, mesh.shape[node], mesh.size,
                    method="tam")
    return make_spmd_executor(mesh, plan, use_kernels=use_kernels,
                              device=device)


def make_tam_read(mesh: RankMesh, layout: FileLayout, cfg: IOConfig,
                  device=None):
    """TAM collective read — an EXPLICIT alias of the two-phase read
    schedule, as in the reference: every rank takes part in every hop,
    so the slow-axis transfer is the same one-window-per-round broadcast
    either way. The plan records this as ``tam_read_fallback``, asserted
    here. Same inputs and output as
    :func:`repro_torch.core.twophase.make_twophase_read`."""
    node = cfg.axis_names[0]
    plan = plan_for(layout, cfg, mesh.shape[node], mesh.size,
                    method="tam", direction="read")
    assert plan.tam_read_fallback, (
        "TAM read compiles to the two-phase window broadcast; the plan "
        "must record the fallback explicitly")
    return make_spmd_executor(mesh, plan, device=device)
