"""Production mesh construction and the card's peaks (the port of the
reference's ``launch/mesh.py``).

The meshes are emulated (``compat.EmulatedMesh``): named rank grids with
no devices behind them, which the port's rank-axis forms of the mesh
paths run on one card. The hardware constants are the NVIDIA H100 SXM's
data-sheet peaks (dense, without sparsity, at its 700 W power limit),
which the roofline (``launch/roofline.py``) and ``chip_smoke.py``'s
kernel bounds read; the reference's are TPU v5e's.
"""
from __future__ import annotations

from repro_torch.compat import EmulatedMesh
from repro_torch.core.spmd_exec import RankMesh
from repro_torch.models.sharding import ShardingPlan


def make_production_mesh(*, multi_pod: bool = False) -> EmulatedMesh:
    """``(data 16, model 16)``, or ``(pod 2, data 16, model 16)``."""
    if multi_pod:
        return EmulatedMesh((2, 16, 16), ("pod", "data", "model"))
    return EmulatedMesh((16, 16), ("data", "model"))


def make_plan(mesh, shard_seq: bool = True) -> ShardingPlan:
    axes = mesh.axis_names
    data_axes = ("pod", "data") if "pod" in axes else ("data",)
    return ShardingPlan(mesh=mesh, data_axes=data_axes, model_axis="model",
                        shard_seq=shard_seq)


def make_io_mesh(n_nodes: int, lagg: int, lmem: int) -> RankMesh:
    """The 3-D collective-I/O rank grid (node, lagg, lmem): see
    ``core.spmd_exec``."""
    return RankMesh(n_nodes, lagg, lmem)


# Hardware constants (NVIDIA H100 SXM data sheet) for the roofline.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 dense on the tensor cores
PEAK_FLOPS_TF32 = 495e12          # FLOP/s, TF32 dense on the tensor cores
PEAK_FLOPS_F32 = 67e12            # FLOP/s, f32 outside the tensor cores
HBM_BW = 3.35e12                  # bytes/s of device memory
NVLINK_BW = 450e9                 # bytes/s a direction: the collective wire
