"""Baseline two-phase collective write (port of ``repro.core.twophase``).

The paper's comparison baseline: every rank routes its requests directly
to the global aggregator owning the destination file domain
(all-to-many); aggregators merge-sort the received offset-length pairs
and place payloads into their file-domain buffers. A thin wrapper: the
schedule is compiled once (``compile_plan``) and handed to the rank-axis
executor (``spmd_exec``). One global aggregator per node; the rank grid
is ``(node, lagg, lmem)`` (``spmd_exec.RankMesh``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.domains import FileLayout
from repro_torch.core.plan import (IOConfig, IOPlan, compile_plan,  # noqa: F401
                                   resolve_cb_buffer_size)
from repro_torch.core.spmd_exec import RankMesh, make_spmd_executor


def plan_for(layout: FileLayout, cfg: IOConfig, n_nodes: int,
             n_ranks: int, method: str = "twophase",
             direction: str = "write", machine=None,
             workload=None) -> IOPlan:
    """Compile the schedule the entry points execute: one global
    aggregator per node (contiguous file domains)."""
    return compile_plan(layout, cfg, n_aggregators=n_nodes,
                        n_nodes=n_nodes, n_ranks=n_ranks, method=method,
                        direction=direction, machine=machine,
                        workload=workload)


def make_twophase_write(mesh: RankMesh, layout: FileLayout, cfg: IOConfig,
                        device=None):
    """Build the baseline collective write.

    Inputs (global shapes): offsets/lengths ``[P, req_cap]``, count
    ``[P]``, data ``[P, data_cap]``. Output: file
    ``[n_nodes, domain_len]``; stats. Runs on the card unless
    ``device="cpu"``.
    """
    node = cfg.axis_names[0]
    plan = plan_for(layout, cfg, mesh.shape[node], mesh.size)
    return make_spmd_executor(mesh, plan, device=device)


def make_twophase_read(mesh: RankMesh, layout: FileLayout, cfg: IOConfig,
                       device=None):
    """Build the baseline collective read: aggregators broadcast their
    file domains one ``cb`` window per round (the whole domain when
    ``cb_buffer_size`` is None), every rank gathers its own requests.

    Inputs: offsets/lengths ``[P, req_cap]``, count ``[P]``, the file
    ``[n_nodes, domain_len]``. Output: payloads ``[P, data_cap]``. Runs
    on the card unless ``device="cpu"``.
    """
    node = cfg.axis_names[0]
    plan = plan_for(layout, cfg, mesh.shape[node], mesh.size,
                    direction="read")
    return make_spmd_executor(mesh, plan, device=device)


def write_reference(layout: FileLayout, offsets, lengths, counts, data):
    """Host-side oracle: scatter every rank's payload into a dense file
    (numpy, independent of the executor)."""
    data = np.asarray(data)
    file = np.zeros((layout.file_len,), dtype=data.dtype)
    offsets, lengths = np.asarray(offsets), np.asarray(lengths)
    counts = np.asarray(counts)
    for p in range(offsets.shape[0]):
        pos = 0
        for i in range(counts[p]):
            o, ln = int(offsets[p, i]), int(lengths[p, i])
            file[o:o + ln] = data[p, pos:pos + ln]
            pos += ln
    return file
