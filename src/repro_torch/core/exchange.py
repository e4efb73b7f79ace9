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

The payload's element routing (:func:`repack_sorted`, and the element
half of :func:`bucket_by_dest`) has two bodies that agree bit for bit.
On CUDA tensors each request becomes one span (where it lands, how many
elements, where they start), computed on the ``[..., cap]`` request
metadata, and ``kernels.ops.route_spans`` copies the spans into the
padded rows; no index the size of the payload is built, and a row the
kernel cannot take (positions past int32, elements of another width)
raises. On CPU tensors the torch body walks every padded slot with the
reference's jnp idioms. The tensors' device alone decides
(:func:`_routes_on_kernel`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import trace
from repro_torch.core._tensor import (bits_of, exclusive_cumsum, repeat_index,
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

    On CUDA tensors ``starts`` must be each valid request's packed
    position, ``coalesce.request_starts(r)`` (as every caller passes):
    the kernel copies spans that are sorted and disjoint only then. Other
    starts may send two requests' elements to one slot, where the torch
    body's scatter keeps either.
    """
    lead = r.offsets.shape[:-1]
    cap = r.capacity
    in_dcap = data.shape[-1]
    trace.count("route_slots", math.prod(lead) * in_dcap)
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
    route = _route_elements_torch
    if _routes_on_kernel(data):
        trace.count("route_kernel_slots", math.prod(lead) * in_dcap)
        route = _route_elements_spans
    out_data, dropped_elems = route(d, order, dstart_grouped, lens_valid,
                                    starts, data, n_dest, data_cap)

    return Buckets(out_off.view(*lead, n_dest, req_cap),
                   out_len.view(*lead, n_dest, req_cap),
                   counts, out_data, dropped_req, dropped_elems)


def _routes_on_kernel(data: torch.Tensor) -> bool:
    """Whether a routing call copies spans with ``kernels.ops.route_spans``
    (every payload off the CPU) or walks every slot with the torch body
    (CPU payloads)."""
    return data.device.type != "cpu"


def _route_elements_torch(d, order, dstart_grouped, lens_valid, starts,
                          data, n_dest, data_cap):
    """``bucket_by_dest``'s element routing as the reference writes it:
    every payload slot finds its request (``repeat_index``), its bucket
    position, and is scattered there. Returns ``(data [..., n_dest,
    data_cap], dropped_elems)``."""
    lead, cap = d.shape[:-1], d.shape[-1]
    in_dcap = data.shape[-1]
    dev = d.device
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
    return out_data.view(*lead, n_dest, data_cap), dropped_elems


def _route_elements_spans(d, order, dstart_grouped, lens_valid, starts,
                          data, n_dest, data_cap):
    """``_route_elements_torch`` as one span a request, copied by
    ``kernels.ops.route_spans``.

    Element e of the payload belongs to the valid request i with
    ``cum_i <= e < cum_i + len_i`` (``cum``: the exclusive prefix of the
    valid lengths) and goes to position ``e + dstart_i - starts_i`` of
    bucket ``d_i``; it is kept where e lies inside the payload and the
    position inside the bucket. So request i's kept elements are one
    range of e, and each request's dropped elements are its routed ones
    less that range. The spans are taken in the bucketing's grouped order
    (destination-major, offset order inside), in which they are sorted
    and disjoint whenever each valid request's payload starts at its
    packed position (``starts`` = ``coalesce.request_starts``, as every
    caller passes). Returns ``(data [..., n_dest, data_cap],
    dropped_elems)``."""
    from repro_torch.kernels import ops as kops
    lead = d.shape[:-1]
    in_dcap = data.shape[-1]
    gd = d.gather(-1, order)
    routed = gd < n_dest
    cum = (torch.cumsum(lens_valid, dim=-1) - lens_valid).gather(-1, order)
    n = torch.where(routed, lens_valid.gather(-1, order), 0)
    shift = dstart_grouped - starts.to(torch.int64).gather(-1, order)
    end = (cum + n).clamp(max=in_dcap)       # routed elements: [cum, end)
    lo = torch.maximum(cum, -shift)
    kept = (torch.minimum(end, data_cap - shift) - lo).clamp(min=0)
    dropped_elems = ((end - cum).clamp(min=0) - kept).sum(
        dim=-1).to(torch.int32)
    if in_dcap == 0:       # no element to route, none dropped
        return (data.new_zeros(*lead, n_dest, data_cap),
                dropped_elems)
    at = torch.where(routed, gd * data_cap + (lo + shift).clamp(0, data_cap),
                     n_dest * data_cap)
    out = kops.route_spans(at.to(torch.int32), kept.to(torch.int32),
                           lo.clamp(0, in_dcap).to(torch.int32), data,
                           n_dest * data_cap)
    return out.view(*lead, n_dest, data_cap), dropped_elems


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
    slots = math.prod(r_sorted.lengths.shape[:-1]) * out_cap
    trace.count("route_slots", slots)
    if _routes_on_kernel(data_flat):
        trace.count("route_kernel_slots", slots)
        return _repack_sorted_spans(r_sorted, starts, data_flat, out_cap)
    return _repack_sorted_torch(r_sorted, starts, data_flat, out_cap)


def _repack_sorted_torch(r_sorted: RequestList, starts: torch.Tensor,
                         data_flat: torch.Tensor,
                         out_cap: int) -> torch.Tensor:
    """``repack_sorted`` as the reference writes it: every output slot
    finds its request (``repeat_index``) and gathers its element."""
    lengths = r_sorted.lengths.to(torch.int64)
    total = lengths.sum(dim=-1, keepdim=True)
    eidx = torch.arange(out_cap, device=lengths.device)
    req_of = repeat_index(lengths, out_cap)
    new_starts = torch.cumsum(lengths, dim=-1) - lengths
    src = (starts.to(torch.int64).gather(-1, req_of)
           + (eidx - new_starts.gather(-1, req_of)))
    del req_of
    src = src.clamp_(0, data_flat.shape[-1] - 1)
    vals = bits_of(data_flat).gather(-1, src).view(data_flat.dtype)
    return torch.where(eidx < total, vals,
                       torch.zeros((), dtype=data_flat.dtype,
                                   device=data_flat.device))


def _repack_sorted_spans(r_sorted: RequestList, starts: torch.Tensor,
                         data_flat: torch.Tensor,
                         out_cap: int) -> torch.Tensor:
    """``_repack_sorted_torch`` as one span a request, copied by
    ``kernels.ops.route_spans``: request i's elements, from ``starts[i]``
    (clamped into the row, element by element, as the torch body
    clamps), land at the exclusive prefix sum of the lengths, cut at
    ``out_cap``; the rest of the row is 0. Starts of another type are
    clamped into ``[-2^31, dcap]`` first, which changes no clamped
    element: a span is shorter than 2^31."""
    from repro_torch.kernels import ops as kops
    lengths = r_sorted.lengths.to(torch.int64)
    at = (torch.cumsum(lengths, dim=-1) - lengths).clamp_(max=out_cap)
    n = torch.minimum(lengths, out_cap - at)
    if starts.dtype != torch.int32:
        starts = starts.clamp(-2**31, data_flat.shape[-1]).to(torch.int32)
    return kops.route_spans(at.to(torch.int32), n.to(torch.int32), starts,
                            data_flat, out_cap)
