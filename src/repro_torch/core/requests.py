"""Request model for collective I/O (the port of ``repro.core.requests``).

An I/O request list is ROMIO's flattened MPI file view: (file offset,
length) pairs, sorted in nondecreasing offset order per rank.

Request lists are fixed-capacity int32 tensors with a ``count``; unused
slots are padded with ``PAD_OFFSET`` (which sorts to the end) and zero
length. Offsets and lengths are in ELEMENTS (4-byte words). Leading axes
are a batch: the rank-axis executor keeps every rank's list as one row
of a ``[P, cap]`` tensor, with ``count`` of shape ``[P]``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core._tensor import stable_partition_order

ELEM_BYTES = 4  # element = one 4-byte word
PAD_OFFSET = 2**31 - 1


class RequestList(NamedTuple):
    """Fixed-capacity list of (offset, length) pairs, offset-sorted.

    offsets: int32[..., cap] — element offsets into the file; PAD_OFFSET pad.
    lengths: int32[..., cap] — element counts; 0 for padding slots.
    count:   int32[...] — number of valid leading entries.
    """

    offsets: torch.Tensor
    lengths: torch.Tensor
    count: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.offsets.shape[-1]

    def valid_mask(self) -> torch.Tensor:
        idx = torch.arange(self.capacity, device=self.offsets.device,
                           dtype=torch.int32)
        return idx < self.count.unsqueeze(-1)

    def total_elems(self) -> torch.Tensor:
        return self.lengths.sum(dim=-1, dtype=torch.int32)


def make_requests(offsets, lengths, capacity: int | None = None, *,
                  device=None) -> RequestList:
    """Build a 1-D RequestList from (possibly shorter) offset/length
    arrays. Tensors keep their device; other inputs go to ``device``
    (the card unless ``device="cpu"``)."""
    if not isinstance(offsets, torch.Tensor):
        device = resolve_device(device)
    else:
        device = offsets.device
    offsets = torch.as_tensor(offsets, dtype=torch.int32, device=device)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    n = offsets.shape[0]
    cap = capacity if capacity is not None else n
    if cap < n:
        raise ValueError(f"capacity {cap} < number of requests {n}")
    off = torch.full((cap,), PAD_OFFSET, dtype=torch.int32, device=device)
    ln = torch.zeros((cap,), dtype=torch.int32, device=device)
    off[:n] = offsets
    ln[:n] = lengths
    return RequestList(off, ln, torch.tensor(n, dtype=torch.int32,
                                             device=device))


def mask_invalid(r: RequestList) -> RequestList:
    """Force padding convention on all slots >= count."""
    m = r.valid_mask()
    return RequestList(torch.where(m, r.offsets, PAD_OFFSET),
                       torch.where(m, r.lengths, 0), r.count)


def split_at_stripes(r: RequestList, stripe_size: int,
                     max_spans: int) -> RequestList:
    """Split every request at stripe boundaries.

    After splitting, each request lies entirely within one stripe, so it
    routes to exactly one global aggregator. Each input request may span
    at most ``max_spans`` stripes; output capacity is cap * max_spans.
    The span arithmetic runs in int64 and the result is int32.
    """
    cap = r.capacity
    lead = r.offsets.shape[:-1]
    o = r.offsets.to(torch.int64)
    ln_in = r.lengths.to(torch.int64)
    s0 = o // stripe_size
    j = torch.arange(max_spans, device=o.device, dtype=torch.int64)
    # span j of request i covers [max(o, (s0+j)*S), min(o+l, (s0+j+1)*S))
    lo = torch.maximum(o.unsqueeze(-1), (s0.unsqueeze(-1) + j) * stripe_size)
    hi = torch.minimum((o + ln_in).unsqueeze(-1),
                       (s0.unsqueeze(-1) + j + 1) * stripe_size)
    ln = (hi - lo).clamp_(min=0)
    valid = (ln > 0) & r.valid_mask().unsqueeze(-1)
    off_flat = torch.where(valid, lo, PAD_OFFSET).reshape(
        *lead, cap * max_spans).to(torch.int32)
    len_flat = torch.where(valid, ln, 0).reshape(
        *lead, cap * max_spans).to(torch.int32)
    # compact: spans are generated in nondecreasing offset order, so a
    # stable partition of the live spans keeps offset order
    order = stable_partition_order(len_flat > 0)
    return RequestList(off_flat.gather(-1, order),
                       len_flat.gather(-1, order),
                       valid.sum(dim=(-2, -1), dtype=torch.int32))


def requests_from_numpy(O, L, C, D, device=None):
    """Per-rank request tensors from the numpy arrays both sides share.

    O/L: ``[P, req_cap]`` offsets and lengths, C: ``[P]`` counts,
    D: ``[P, data_cap]`` payload. Returns ``(offsets, lengths, count,
    data)`` on ``device`` (the card unless ``device="cpu"``): int32
    metadata and the payload in its own dtype — the inputs of the
    write executors of ``repro_torch.core.spmd_exec``.
    """
    device = resolve_device(device)
    O, L, C, D = (np.asarray(x) for x in (O, L, C, D))
    if O.ndim != 2 or L.shape != O.shape or C.shape != O.shape[:1]:
        raise ValueError(
            f"expected O, L [P, req_cap] and C [P]; got {O.shape}, "
            f"{L.shape}, {C.shape}")
    if D.ndim != 2 or D.shape[0] != O.shape[0]:
        raise ValueError(f"expected D [P, data_cap]; got {D.shape}")
    as_i32 = lambda x: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x, dtype=np.int32)).to(device)
    return (as_i32(O), as_i32(L), as_i32(C),
            torch.from_numpy(np.ascontiguousarray(D)).to(device))
