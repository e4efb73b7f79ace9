"""Batched sort of request rows: the port of
``repro.kernels.sort.bitonic_sort``.

The TPU sorts each ``[n]`` row with a bitonic network held in VMEM. The
Hopper kernels (``csrc/bitonic.cuh``, ``csrc/sort.cu``) spread each row
over many CTAs: every entry becomes one 64-bit word (the key with its
sign bit flipped above its row position, so words are unique and order
as a stable sort), blocks of ``sort_block(n)`` words are sorted by
bitonic networks, and ``merge_passes(n)`` merge-path passes merge them
pairwise, the last one writing the offsets and gathering the carries by
position. :func:`repro_torch.kernels.ref.sort_blocks_merge_ref` is that
algorithm in plain PyTorch. On a CPU tensor the wrapper runs the plain
version, :func:`repro_torch.kernels.ref.sort_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import SORT_BLOCK, sort_ref

MAX_BLOCK = 32768  # the longest row: the TPU kernel's MAX_BLOCK


def sort_block(n: int) -> int:
    """Words each block-sort CTA sorts in a row of ``n``."""
    return min(n, SORT_BLOCK)


def merge_passes(n: int) -> int:
    """Merge launches after the block sort: log2(n / sort_block(n))."""
    return (n // sort_block(n)).bit_length() - 1


def word_scratch(b: int, n: int, device) -> torch.Tensor:
    """The sort's 64-bit scratch between launches: ``min(passes, 2)``
    ping-pong planes of ``[b, n]`` (none where the block sort is the
    only launch)."""
    return torch.empty((min(merge_passes(n), 2), b, n), dtype=torch.int64,
                       device=device)


def bitonic_sort(offsets: torch.Tensor, lengths: torch.Tensor,
                 carry: torch.Tensor):
    """Sort ``[b, n]`` int32 rows by offset, carrying lengths and
    ``carry``. n is a power of two <= MAX_BLOCK. CUDA tensors launch the
    kernels (one count in ``bitonic_sort.launches`` per call); CPU
    tensors run ``sort_ref``."""
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
    words = word_scratch(b, n, offsets.device)
    lib = build.load_library()
    with torch.cuda.device(offsets.device):
        rc = lib.repro_bitonic_sort(
            offsets.data_ptr(), lengths.data_ptr(), carry.data_ptr(),
            *(o.data_ptr() for o in outs), words.data_ptr(), b, n,
            build.stream_of(offsets))
    build.check(lib, "bitonic_sort", rc)
    bitonic_sort.launches += 1
    return outs


bitonic_sort.launches = 0
