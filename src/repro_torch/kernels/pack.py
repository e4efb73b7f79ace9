"""Gather-form pack of sorted request payloads: the port of
``repro.kernels.pack.pack``, and the round engine's span copy.

For every output position, in tiles of 4096, binary-search the
offset-sorted, non-overlapping requests for the one covering
``position + base`` and pull its payload element, else 0. The Hopper
kernel (``csrc/pack.cu``) is the tile kernel of ``fused_sort_pack``
(``csrc/pack_tiles.cuh``) with no sort launch and no mask. On a CPU
tensor the wrapper runs the plain version,
:func:`repro_torch.kernels.ref.pack_ref`.

:func:`route_spans` (``csrc/route_spans.cu``, no TPU counterpart) walks
the same tiles over batched rows of spans at base 0, with a ragged last
tile: the element routing of ``core.exchange.repack_sorted`` and
``bucket_by_dest`` on the card. Its plain version is
:func:`repro_torch.kernels.ref.route_spans_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import pack_ref, route_spans_ref

MAX_REQ_BLOCK = 32768
TILE = 4096
MAX_ROUTE_LEN = 2**31 - 1      # route_spans' positions are int32


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


def route_spans(offsets: torch.Tensor, lengths: torch.Tensor,
                sources: torch.Tensor, data: torch.Tensor,
                out_len: int) -> torch.Tensor:
    """Copy spans of payload rows into zeroed rows ``[b, out_len]``.

    offsets/lengths/sources: int32 ``[b, cap]``; each row's spans are
    sorted by offset and disjoint (offsets in ``[0, out_len]``, lengths
    >= 0). data: ``[b, dcap]``, ``0 < dcap < 2^31``, of 1, 2, 4 or 8-byte
    elements. Position p of row i takes ``data[i, clamp(sources[i, r] +
    p - offsets[i, r], 0, dcap - 1)]`` from the last span r with
    ``offsets[i, r] <= p`` if ``p - offsets[i, r] < lengths[i, r]``,
    else 0; the bits are copied as they are. CUDA tensors launch the
    kernel (counted in ``route_spans.launches``); CPU tensors run
    ``route_spans_ref``.
    """
    if offsets.dim() != 2 or lengths.shape != offsets.shape \
            or sources.shape != offsets.shape or data.dim() != 2 \
            or data.shape[0] != offsets.shape[0]:
        raise ValueError("route_spans takes [b, cap] spans and [b, dcap] "
                         "data")
    if not 0 <= out_len <= MAX_ROUTE_LEN:
        raise ValueError(f"out_len {out_len} outside [0, {MAX_ROUTE_LEN}]")
    if not 0 < data.shape[1] <= MAX_ROUTE_LEN:
        raise ValueError(f"route_spans takes payload rows of 1 to "
                         f"{MAX_ROUTE_LEN} elements, not {data.shape[1]}")
    if data.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"route_spans copies 1, 2, 4 or 8-byte elements, "
                        f"not {data.dtype}")
    if offsets.device.type == "cpu":
        return route_spans_ref(offsets, lengths, sources, data, out_len)
    build.require_cuda("route_spans", offsets, lengths, sources,
                       dtype=torch.int32)
    build.require_cuda("route_spans", offsets, data)
    b, cap = offsets.shape
    out = torch.empty((b, out_len), dtype=data.dtype, device=data.device)
    lib = build.load_library()
    with torch.cuda.device(offsets.device):
        rc = lib.repro_route_spans(
            offsets.data_ptr(), lengths.data_ptr(), sources.data_ptr(),
            data.data_ptr(), out.data_ptr(), b, cap, data.shape[1], out_len,
            data.element_size(), build.stream_of(offsets))
    build.check(lib, "route_spans", rc)
    route_spans.launches += 1
    return out


route_spans.launches = 0
