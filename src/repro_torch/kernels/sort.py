"""Batched bitonic sort of request rows: the port of
``repro.kernels.sort.bitonic_sort``.

The TPU sorts each ``[n]`` row with a bitonic network held in VMEM. The
Hopper kernel (``csrc/bitonic.cuh``, ``csrc/sort.cu``) runs the network
on ``(key, slot)`` pairs in one CTA's shared memory and gathers the
carries by slot afterwards; ties break by slot, so the result equals a
stable sort. On a CPU tensor the wrapper runs the plain version,
:func:`repro_torch.kernels.ref.sort_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import sort_ref

MAX_BLOCK = 32768  # pairs per CTA: 6 B each in shared memory (192 KiB)


def bitonic_sort(offsets: torch.Tensor, lengths: torch.Tensor,
                 carry: torch.Tensor):
    """Sort ``[b, n]`` int32 rows by offset, carrying lengths and
    ``carry``. n is a power of two <= MAX_BLOCK. CUDA tensors launch the
    kernel (counted in ``bitonic_sort.launches``); CPU tensors run
    ``sort_ref``."""
    if offsets.dim() != 2 or lengths.shape != offsets.shape \
            or carry.shape != offsets.shape:
        raise ValueError("bitonic_sort takes three [b, n] tensors")
    b, n = offsets.shape
    if n & (n - 1) or n > MAX_BLOCK:
        raise ValueError(
            f"block length {n} must be a power of two <= {MAX_BLOCK}")
    if offsets.device.type == "cpu":
        return sort_ref(offsets, lengths, carry)
    build.require_cuda("bitonic_sort", offsets, lengths, carry,
                       dtype=torch.int32)
    outs = tuple(torch.empty_like(x) for x in (offsets, lengths, carry))
    lib = build.load_library()
    with torch.cuda.device(offsets.device):
        rc = lib.repro_bitonic_sort(
            offsets.data_ptr(), lengths.data_ptr(), carry.data_ptr(),
            *(o.data_ptr() for o in outs), b, n, build.stream_of(offsets))
    build.check(lib, "bitonic_sort", rc)
    bitonic_sort.launches += 1
    return outs


bitonic_sort.launches = 0
