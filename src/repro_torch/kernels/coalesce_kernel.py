"""Coalesce of offset-sorted request rows: the port of
``repro.kernels.coalesce_kernel.coalesce``.

Merges every run with ``off[i] + len[i] == off[i+1]`` and compacts the
runs to the front. The Hopper kernel (``csrc/coalesce_kernel.cu``) runs
one CTA per row: boundary detection, a block-wide scan (warp shuffles
plus shared memory), and a compacting store of run heads and lengths.
On a CPU tensor the wrapper runs the plain version,
:func:`repro_torch.kernels.ref.coalesce_ref`.
"""
from __future__ import annotations

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
