"""Sort + coalesce of offset-length request lists (port of
``repro.core.coalesce``, the plain-torch path).

This is the algorithmic heart of the paper's aggregation layers: each
(local or global) aggregator merge-sorts the offset-length pairs
gathered from its senders and coalesces consecutive contiguous pairs
(``offset[i] + length[i] == offset[i+1]``) into single larger requests.

The CUDA kernels in ``repro_torch.kernels`` implement the same
operations for the card; this module is the plain version the unfused
paths run. Leading axes are a batch throughout.
"""
from __future__ import annotations

import torch

from repro_torch.core._tensor import repeat_index, scatter_new
from repro_torch.core.requests import PAD_OFFSET, RequestList, mask_invalid

_INT32_MAX = 2**31 - 1


def sort_requests(r: RequestList) -> RequestList:
    """Sort requests by offset (stable; padding sorts to the end)."""
    r = mask_invalid(r)
    order = torch.argsort(r.offsets, dim=-1, stable=True)
    return RequestList(r.offsets.gather(-1, order),
                       r.lengths.gather(-1, order), r.count)


def coalesce_sorted(r: RequestList) -> RequestList:
    """Coalesce adjacent contiguous requests of an offset-sorted list.

    Returns a compacted RequestList (valid entries at the front) with
    the same capacity. Zero-length requests must not appear among the
    valid entries (the padding convention reserves length 0).
    """
    off = r.offsets.to(torch.int64)
    ln = r.lengths.to(torch.int64)
    cap = r.capacity
    lead = off.shape[:-1]
    prev_end = torch.cat([torch.full((*lead, 1), -1, dtype=torch.int64,
                                     device=off.device),
                          (off + ln)[..., :-1]], dim=-1)
    is_pad = off == PAD_OFFSET
    # a new segment starts where the request is not contiguous with the
    # previous one; padding always starts its own (discarded) segment.
    boundary = (off != prev_end) | is_pad
    seg = torch.cumsum(boundary.to(torch.int64), dim=-1) - 1
    # segment_min over an empty segment is int32 max == PAD_OFFSET
    seg_off = torch.full((*lead, cap), _INT32_MAX, dtype=torch.int64,
                         device=off.device).scatter_reduce_(
        -1, seg, torch.where(is_pad, PAD_OFFSET, off), "amin",
        include_self=True)
    seg_len = torch.zeros((*lead, cap), dtype=torch.int64,
                          device=off.device).scatter_add_(
        -1, seg, torch.where(is_pad, 0, ln))
    last = (r.count.to(torch.int64) - 1).clamp(min=0).unsqueeze(-1)
    n_seg = torch.where(r.count > 0, seg.gather(-1, last).squeeze(-1) + 1,
                        0)
    valid = torch.arange(cap, device=off.device) < n_seg.unsqueeze(-1)
    return RequestList(
        torch.where(valid, seg_off, PAD_OFFSET).to(torch.int32),
        torch.where(valid, seg_len, 0).to(torch.int32),
        n_seg.to(torch.int32))


def _base_col(base, ref: torch.Tensor):
    """A scalar base, or a per-row base broadcast against ``[..., n]``."""
    if isinstance(base, torch.Tensor):
        return base.to(device=ref.device, dtype=torch.int64).unsqueeze(-1)
    return int(base)


def pack_data(r: RequestList, starts: torch.Tensor, data: torch.Tensor,
              out_len: int, base=0) -> torch.Tensor:
    """Scatter request payloads into a contiguous buffer.

    The "memory operation for moving the request data into a contiguous
    space based on the sorted offsets" (paper §V-A) and the
    aggregator-side placement into its file domain. ``base`` (an int or
    one value per row) is subtracted from the offsets; elements mapping
    outside ``[0, out_len)`` are dropped (negative positions wrap once,
    as the reference's scatter does).
    """
    lengths = r.lengths.to(torch.int64)
    dcap = data.shape[-1]
    req_of = repeat_index(lengths, dcap)
    eidx = torch.arange(dcap, device=data.device)
    packed_starts = torch.cumsum(lengths, dim=-1) - lengths
    within = eidx - packed_starts.gather(-1, req_of)
    src = starts.to(torch.int64).gather(-1, req_of) + within
    dst = (r.offsets.to(torch.int64).gather(-1, req_of) + within
           - _base_col(base, data))
    del req_of, within
    live = eidx < lengths.sum(dim=-1, keepdim=True)
    vals = data.gather(-1, src.clamp_(0, dcap - 1))
    dst = torch.where(live, dst, out_len)
    return scatter_new(out_len, 0, dst, vals)


def unpack_data(r: RequestList, starts: torch.Tensor, buf: torch.Tensor,
                out_len: int, base=0) -> torch.Tensor:
    """Gather request payloads out of a contiguous buffer (read path);
    ``buf`` is one buffer per row, or one for every row."""
    lengths = r.lengths.to(torch.int64)
    req_of = repeat_index(lengths, out_len)
    eidx = torch.arange(out_len, device=buf.device)
    within = eidx - starts.to(torch.int64).gather(-1, req_of)
    pos = (r.offsets.to(torch.int64).gather(-1, req_of) + within
           - _base_col(base, buf))
    live = eidx < lengths.sum(dim=-1, keepdim=True)
    pos = torch.where(live, pos, 0).clamp_(0, buf.shape[-1] - 1)
    # one buffer may serve every row of a batch
    vals = buf.expand(*pos.shape[:-1], buf.shape[-1]).gather(-1, pos)
    return torch.where(live, vals, torch.zeros((), dtype=buf.dtype,
                                               device=buf.device))


def request_starts(r: RequestList) -> torch.Tensor:
    """Start of each request's payload in the packed data buffer."""
    ends = torch.cumsum(r.lengths, dim=-1)
    return (ends - r.lengths).to(torch.int32)
