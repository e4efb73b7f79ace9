"""Static-shape request/data routing primitives (port of
``repro.core.exchange``).

MPI two-phase I/O routes each request to the global aggregator owning
its file domain with point-to-point sends. With static shapes, routing
becomes: bucket requests (and their payload elements) by destination
into fixed-capacity per-destination buckets, then exchange the buckets.
In the port the exchange is a transpose of the rank axis
(``repro_torch.core.rounds``).

Every function works on the last axis and treats leading axes as a
batch (one row per rank or per local-aggregator group). Capacities and
drop accounting are the reference's, because the drop stats and byte
identity depend on them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core._tensor import (exclusive_cumsum, repeat_index,
                                      scatter_new)
from repro_torch.core.requests import PAD_OFFSET, RequestList


class Buckets(NamedTuple):
    """Per-destination request buckets plus packed payload buckets.

    offsets: int32[..., n_dest, req_cap]
    lengths: int32[..., n_dest, req_cap]
    counts:  int32[..., n_dest]
    data:    dtype[..., n_dest, data_cap] — payload elements, packed in
             request order within each bucket.
    dropped_requests / dropped_elems: int32[...] — overflow accounting.
    """

    offsets: torch.Tensor
    lengths: torch.Tensor
    counts: torch.Tensor
    data: torch.Tensor
    dropped_requests: torch.Tensor
    dropped_elems: torch.Tensor


def sort_with(r: RequestList, *extras: torch.Tensor):
    """Sort requests by offset (stable), permuting ``extras`` identically.

    Padding may be interspersed (e.g. flattened buckets); sorting
    compacts the valid entries to the front.
    """
    order = torch.argsort(r.offsets, dim=-1, stable=True)
    sorted_r = RequestList(r.offsets.gather(-1, order),
                           r.lengths.gather(-1, order), r.count)
    return (sorted_r, *[e.gather(-1, order) for e in extras])


def bucket_by_dest(r: RequestList, starts: torch.Tensor,
                   data: torch.Tensor, dest: torch.Tensor, n_dest: int,
                   req_cap: int, data_cap: int) -> Buckets:
    """Group requests + payload elements into per-destination buckets.

    r:      offset-sorted requests ``[..., cap]``.
    starts: payload start of each request inside ``data``.
    data:   ``[..., in_dcap]`` payload.
    dest:   destination id in [0, n_dest) per request.
    """
    lead = r.offsets.shape[:-1]
    cap = r.capacity
    in_dcap = data.shape[-1]
    dev = r.offsets.device
    valid = r.valid_mask()
    d = torch.where(valid, dest.to(torch.int64), n_dest)   # invalid -> sink

    # --- request-level grouping -------------------------------------
    order = torch.argsort(d, dim=-1, stable=True)   # groups in offset order
    go = r.offsets.gather(-1, order)
    gl = r.lengths.gather(-1, order).to(torch.int64)
    gd = d.gather(-1, order)
    grp_counts = torch.zeros(*lead, n_dest + 1, dtype=torch.int64,
                             device=dev).scatter_add_(-1, d,
                                                      valid.to(torch.int64))
    grp_start = exclusive_cumsum(grp_counts)
    pos = torch.arange(cap, device=dev) - grp_start.gather(-1, gd)
    req_ok = (gd < n_dest) & (pos < req_cap)
    scatter_idx = torch.where(req_ok, gd * req_cap + pos, n_dest * req_cap)
    out_off = scatter_new(n_dest * req_cap, PAD_OFFSET, scatter_idx, go)
    out_len = scatter_new(n_dest * req_cap, 0, scatter_idx,
                          r.lengths.gather(-1, order))
    counts = grp_counts[..., :n_dest].clamp(max=req_cap).to(torch.int32)
    dropped_req = (grp_counts[..., :n_dest] - req_cap).clamp(min=0).sum(
        dim=-1).to(torch.int32)

    # --- element-level routing ---------------------------------------
    # payload start of each request within its destination bucket:
    # prefix of lengths among same-dest requests placed before it.
    lens_valid = torch.where(valid, r.lengths, 0).to(torch.int64)
    gpre = torch.cumsum(gl, dim=-1) - gl           # global prefix, grouped
    elem_grp_start = exclusive_cumsum(
        torch.zeros(*lead, n_dest + 1, dtype=torch.int64,
                    device=dev).scatter_add_(-1, d, lens_valid))
    dstart_grouped = gpre - elem_grp_start.gather(-1, gd)
    req_dstart = torch.zeros(*lead, cap, dtype=torch.int64,
                             device=dev).scatter_(-1, order, dstart_grouped)

    total = lens_valid.sum(dim=-1, keepdim=True)
    eidx = torch.arange(in_dcap, device=dev)
    req_of = repeat_index(lens_valid, in_dcap)
    e_valid = eidx < total
    e_dest = d.gather(-1, req_of)
    e_pos = (req_dstart.gather(-1, req_of)
             + (eidx - starts.to(torch.int64).gather(-1, req_of)))
    del req_of
    e_routed = e_valid & (e_dest < n_dest)
    e_ok = e_routed & (e_pos < data_cap) & (e_pos >= 0)
    e_scatter = torch.where(e_ok, e_dest * data_cap + e_pos,
                            n_dest * data_cap)
    del e_dest, e_pos
    out_data = scatter_new(n_dest * data_cap, 0, e_scatter, data)
    dropped_elems = (e_routed & ~e_ok).sum(dim=-1).to(torch.int32)

    return Buckets(out_off.view(*lead, n_dest, req_cap),
                   out_len.view(*lead, n_dest, req_cap),
                   counts, out_data.view(*lead, n_dest, data_cap),
                   dropped_req, dropped_elems)


def flatten_buckets(offsets: torch.Tensor, lengths: torch.Tensor,
                    counts: torch.Tensor, data: torch.Tensor):
    """Merge a stack of buckets ``[..., B, cap]`` into one request list
    ``[..., B * cap]`` with payload starts pointing into the flattened
    data buffer ``[..., B * dcap]``.

    Unlike the reference, which flattens every leading axis, the axes
    before the bucket axis stay a batch.
    """
    nb, cap = offsets.shape[-2:]
    lead = offsets.shape[:-2]
    dcap = data.shape[-1]
    per_bucket_starts = (torch.cumsum(lengths, dim=-1) - lengths)
    slab = (torch.arange(nb, device=offsets.device, dtype=torch.int64)
            * dcap).unsqueeze(-1)
    starts = (per_bucket_starts + slab).to(torch.int32).reshape(
        *lead, nb * cap)
    # padding is interspersed (per-bucket suffixes) until the list is
    # sorted; invalid slots are self-describing (PAD_OFFSET / length 0)
    r = RequestList(offsets.reshape(*lead, nb * cap),
                    lengths.reshape(*lead, nb * cap),
                    counts.sum(dim=-1, dtype=torch.int32))
    return r, starts, data.reshape(*lead, nb * dcap)


def repack_sorted(r_sorted: RequestList, starts: torch.Tensor,
                  data_flat: torch.Tensor, out_cap: int) -> torch.Tensor:
    """Pack payloads contiguously in sorted-request order.

    After this, the payload of any coalesced run of contiguous requests
    occupies one contiguous span — which is why TAM's local aggregators
    can forward coalesced metadata with repacked data.
    """
    lengths = r_sorted.lengths.to(torch.int64)
    total = lengths.sum(dim=-1, keepdim=True)
    eidx = torch.arange(out_cap, device=lengths.device)
    req_of = repeat_index(lengths, out_cap)
    new_starts = torch.cumsum(lengths, dim=-1) - lengths
    src = (starts.to(torch.int64).gather(-1, req_of)
           + (eidx - new_starts.gather(-1, req_of)))
    del req_of
    src = src.clamp_(0, data_flat.shape[-1] - 1)
    vals = data_flat.gather(-1, src)
    return torch.where(eidx < total, vals,
                       torch.zeros((), dtype=data_flat.dtype,
                                   device=data_flat.device))
