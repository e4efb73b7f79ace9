"""Hand-written Hopper kernels of the port and their plain versions.

* ``sort.bitonic_sort`` — batched shared-memory bitonic sort (CUDA);
* ``coalesce_kernel.coalesce`` — batched run coalescing (CUDA);
* ``fused_round.fused_sort_pack`` — the per-round drain: sort + window
  and mask from one search per position (CUDA, two launches);
* ``fused_round.zero_skip_encode`` / ``zero_skip_decode`` — the rle
  codec's wire on the slow hop: per-row zero-skip compaction and its
  inverse scatter (CUDA);
* ``ref`` — the plain PyTorch versions the wrappers run on the CPU;
* ``ops`` — padding, chunking and RequestList integration;
* ``build`` — the nvcc build and ctypes loading, at first launch.

Each wrapper counts the calls that launched its kernel in a plain
integer attribute, ``<wrapper>.launches``.
"""
from __future__ import annotations

from repro_torch.kernels.coalesce_kernel import coalesce
from repro_torch.kernels.fused_round import (fused_sort_pack,
                                            zero_skip_decode,
                                            zero_skip_encode)
from repro_torch.kernels.sort import bitonic_sort

KERNELS = (bitonic_sort, coalesce, fused_sort_pack, zero_skip_encode,
           zero_skip_decode)


def launch_counts() -> dict[str, int]:
    """Launch count of every kernel wrapper, by name."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
