"""Coalesce of offset-sorted request rows: the port of
``repro.kernels.coalesce_kernel.coalesce``.

Merges every run with ``off[i] + len[i] == off[i+1]`` and compacts the
runs to the front. The Hopper kernel (``csrc/coalesce_kernel.cu``) gives
each row a thread-block cluster of ``ceil(n / 4096)`` CTAs, one tile of
4096 entries each: a block-wide scan of the tile's boundaries, heads and
lengths, then every CTA reads the totals of its row's tiles through
distributed shared memory and writes each output word once.
:func:`repro_torch.kernels.ref.coalesce_tiled_ref` is that algorithm in
plain PyTorch. On a CPU tensor the wrapper runs the plain version,
:func:`repro_torch.kernels.ref.coalesce_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import coalesce_ref

MAX_BLOCK = 32768


def coalesce(offsets: torch.Tensor, lengths: torch.Tensor):
    """Coalesce ``[b, n]`` int32 rows, offset-sorted with PAD_OFFSET
    padding at the tail. Returns ``(offsets, lengths, counts)``. CUDA
    tensors launch the kernel (counted in ``coalesce.launches``); CPU
    tensors run ``coalesce_ref``."""
    if offsets.dim() != 2 or lengths.shape != offsets.shape:
        raise ValueError("coalesce takes two [b, n] tensors")
    b, n = offsets.shape
    if n > MAX_BLOCK:
        raise ValueError(f"block length {n} > {MAX_BLOCK}")
    if offsets.device.type == "cpu":
        return coalesce_ref(offsets, lengths)
    build.require_cuda("coalesce", offsets, lengths, dtype=torch.int32)
    out_off = torch.empty_like(offsets)
    out_len = torch.empty_like(lengths)
    counts = torch.empty((b,), dtype=torch.int32, device=offsets.device)
    lib = build.load_library()
    with torch.cuda.device(offsets.device):
        rc = lib.repro_coalesce(offsets.data_ptr(), lengths.data_ptr(),
                                out_off.data_ptr(), out_len.data_ptr(),
                                counts.data_ptr(), b, n,
                                build.stream_of(offsets))
    build.check(lib, "coalesce", rc)
    coalesce.launches += 1
    return out_off, out_len, counts


coalesce.launches = 0


def max_active_clusters(n: int = MAX_BLOCK, device=None) -> int:
    """How many of the kernel's row clusters for rows of ``n`` entries
    the card holds at once (``cudaOccupancyMaxActiveClusters``)."""
    lib = build.load_library()
    out = ctypes.c_int(0)
    with torch.cuda.device(device if device is not None else 0):
        rc = lib.repro_coalesce_max_active_clusters(n, ctypes.addressof(out))
    build.check(lib, "coalesce max_active_clusters", rc)
    return out.value
