"""Gather-form pack of sorted request payloads: the port of
``repro.kernels.pack.pack``.

For every output position, in tiles of 4096, binary-search the
offset-sorted, non-overlapping requests for the one covering
``position + base`` and pull its payload element, else 0. The Hopper
kernel (``csrc/pack.cu``) is the tile kernel of ``fused_sort_pack``
(``csrc/pack_tiles.cuh``) with no sort launch and no mask. On a CPU
tensor the wrapper runs the plain version,
:func:`repro_torch.kernels.ref.pack_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import pack_ref

MAX_REQ_BLOCK = 32768
TILE = 4096


def pack(offsets: torch.Tensor, lengths: torch.Tensor, starts: torch.Tensor,
         data: torch.Tensor, base, out_len: int) -> torch.Tensor:
    """Pack payloads into a dense ``[out_len]`` buffer.

    offsets/lengths/starts: int32 ``[cap]``, offset-SORTED and
    non-overlapping (PAD_OFFSET/0 padding at the tail); ``starts[i]``
    locates request i's payload in ``data`` (``[n]``). base: the
    file-domain start, an int. Positions no request covers are 0. CUDA
    tensors launch the kernel (counted in ``pack.launches``); CPU tensors
    run ``pack_ref``.
    """
    cap = offsets.shape[0]
    if offsets.dim() != 1 or lengths.shape != offsets.shape \
            or starts.shape != offsets.shape or data.dim() != 1:
        raise ValueError("pack takes [cap] metadata and [n] data")
    if cap > MAX_REQ_BLOCK:
        raise ValueError(f"request block {cap} > {MAX_REQ_BLOCK}")
    if out_len % TILE:
        raise ValueError(f"out_len must be a multiple of {TILE}")
    if offsets.device.type == "cpu":
        return pack_ref(offsets, lengths, starts, data, base, out_len)
    base_t = torch.full((1,), int(base), dtype=torch.int32,
                        device=offsets.device)
    build.require_cuda("pack", offsets, lengths, starts, base_t,
                       dtype=torch.int32)
    build.require_cuda("pack", offsets, data)
    out = torch.empty(out_len, dtype=data.dtype, device=data.device)
    lib = build.load_library()
    with torch.cuda.device(offsets.device):
        rc = lib.repro_pack(
            offsets.data_ptr(), lengths.data_ptr(), starts.data_ptr(),
            data.data_ptr(), base_t.data_ptr(), out.data_ptr(), cap,
            data.shape[0], out_len, data.element_size(),
            build.stream_of(offsets))
    build.check(lib, "pack", rc)
    pack.launches += 1
    return out


pack.launches = 0
