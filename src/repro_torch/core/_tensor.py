"""Tensor idioms the port needs where the reference leans on jnp.

Three jnp behaviours have no one-call torch counterpart:

* ``jnp.repeat(arange(cap), lengths, total_repeat_length=n)`` pads with
  the LAST input element when the lengths sum to less than ``n``
  (``torch.repeat_interleave(output_size=)`` raises instead):
  :func:`repeat_index`.
* ``x.at[idx].set(v, mode="drop")`` wraps negative indices NumPy-style
  and drops what is still out of range (torch's scatters raise or write
  out of bounds): :func:`scatter_new`, which scatters into a flat buffer
  with one trailing sink slot and slices the sink off.
* ``jnp.argsort(key, stable=True)`` of a 0/1 key is a stable partition:
  :func:`stable_partition_order` computes it with two cumsums.

The reference adds request ends and file positions in int32, where
they wrap; the port sums in int64 and takes :func:`wrap_int32` of the
sum before a compare, a division or an index.

And one torch behaviour the reference does not have: on the CPU,
``scatter_`` of bfloat16 turns a NaN's bits into 0xffff. Scatters that
must move payload bits unchanged scatter :func:`bits_of` the tensors.

Payload streams reach gigabytes (a checkpoint of a model's state):
:func:`gather_spans` gathers byte spans (and :func:`scatter_spans`
writes them back) without an index the size of the stream, and
:func:`cat_views` joins the consecutive splits of one stream without a
copy.

Every helper works on the LAST axis and treats leading axes as a batch.
"""
from __future__ import annotations

import numpy as np
import torch


_INT_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}


def bits_of(x: torch.Tensor) -> torch.Tensor:
    """A float tensor viewed as the signed integers of its width (its
    bits); any other tensor as it is."""
    if x.dtype.is_floating_point:
        return x.view(_INT_OF_WIDTH[x.element_size()])
    return x


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as int32 arithmetic leaves it: its low 32 bits, two's
    complement (int32 out)."""
    return x.to(torch.int32)


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum over the last axis (int64 for integer input)."""
    c = torch.cumsum(x, dim=-1)
    return c - x


def repeat_index(lengths: torch.Tensor, total: int) -> torch.Tensor:
    """``jnp.repeat(arange(cap), lengths, total_repeat_length=total)``.

    Element e belongs to request ``searchsorted(cumsum(lengths), e,
    right=True)``; positions past the lengths' sum take the last index,
    ``cap - 1``, as jnp pads. Returns int64 ``[..., total]``.
    """
    cap = lengths.shape[-1]
    ends = torch.cumsum(lengths.to(torch.int64), dim=-1)
    lead = ends.shape[:-1]
    e = torch.arange(total, device=lengths.device, dtype=torch.int64)
    e = e.expand(*lead, total).contiguous()
    idx = torch.searchsorted(ends.contiguous(), e, right=True)
    return idx.clamp_(max=cap - 1)


def scatter_new(n: int, fill, idx: torch.Tensor, vals: torch.Tensor,
                dtype=None) -> torch.Tensor:
    """``full([..., n], fill).at[idx].set(vals, mode="drop")`` per row.

    ``idx``/``vals`` are ``[..., m]``; negative indices wrap once, and
    anything still outside ``[0, n)`` lands in a sink slot that is cut
    off. The result is a contiguous ``[..., n]`` tensor.
    """
    lead = idx.shape[:-1]
    rows = 1
    for s in lead:
        rows *= s
    dtype = vals.dtype if dtype is None else dtype
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    row_base = (torch.arange(rows, device=idx.device, dtype=torch.int64)
                * n).reshape(*lead, 1) if lead else 0
    flat_idx = torch.where(ok, idx + row_base, rows * n).reshape(-1)
    out = torch.full((rows * n + 1,), fill, dtype=dtype, device=idx.device)
    bits_of(out).scatter_(0, flat_idx, bits_of(vals.reshape(-1).to(dtype)))
    return out[:rows * n].view(*lead, n)


def stable_partition_order(keep: torch.Tensor) -> torch.Tensor:
    """``argsort(where(keep, 0, 1), stable=True)`` along the last axis:
    the kept positions first, then the rest, each in original order."""
    k = keep.to(torch.int64)
    n = k.shape[-1]
    n_keep = k.sum(dim=-1, keepdim=True)
    pos = torch.where(keep, torch.cumsum(k, dim=-1) - 1,
                      n_keep + torch.cumsum(1 - k, dim=-1) - 1)
    src = torch.arange(n, device=keep.device,
                       dtype=torch.int64).expand_as(pos)
    return torch.empty_like(pos).scatter_(-1, pos, src)


def to_host(x, dtype) -> np.ndarray:
    """A numpy array of ``x`` in ``dtype``: a tensor is copied off its
    device, an array converted as ``np.asarray`` does."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(dtype, copy=False)
    return np.asarray(x, dtype)


def byte_index(starts: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Positions ``s .. s + n - 1`` of every ``(s, n)`` (int64), in
    order, concatenated."""
    total = int(lengths.sum().item()) if lengths.numel() else 0
    if total == 0:
        return torch.zeros(0, dtype=torch.int64, device=starts.device)
    req_of = repeat_index(lengths, total)
    return (starts.gather(0, req_of)
            + torch.arange(total, device=starts.device)
            - exclusive_cumsum(lengths).gather(0, req_of))


SPAN_SLICE_MIN = 1 << 16      # a run at least this long copies as a slice
SPAN_GATHER_CHUNK = 1 << 26   # bytes one byte-index gather takes at most


def _span_pieces(starts: torch.Tensor, lengths: torch.Tensor):
    """The spans ``(s, n)`` as pieces in order, each a key into the 1-D
    stream (a slice, or an int64 index of at most
    :data:`SPAN_GATHER_CHUNK` elements) and its length.

    Spans that continue each other merge into runs. A run of at least
    :data:`SPAN_SLICE_MIN` elements is a slice; the short runs between
    them are indexed through :func:`byte_index`, a chunk at a time, so
    the index never outgrows the chunk however large the stream is."""
    starts, lengths = starts.to(torch.int64), lengths.to(torch.int64)
    head = torch.ones(lengths.numel(), dtype=torch.bool,
                      device=lengths.device)
    head[1:] = starts[1:] != starts[:-1] + lengths[:-1]
    run = torch.cumsum(head.to(torch.int64), 0) - 1
    r_start = starts[head]
    r_len = torch.zeros(r_start.numel(), dtype=torch.int64,
                        device=lengths.device).index_add_(0, run, lengths)
    h_start, h_len = r_start.cpu().numpy(), r_len.cpu().numpy()
    if h_len.size == 1:
        s, n = int(h_start[0]), int(h_len[0])
        yield slice(s, s + n), n
        return
    long_runs = np.flatnonzero(h_len >= SPAN_SLICE_MIN)
    lo = 0
    for b in list(long_runs) + [h_len.size]:
        # the short runs [lo, b), in chunks, then the long run b
        ends = np.cumsum(h_len[lo:b])
        cut = 0
        while cut < b - lo:
            base = int(ends[cut - 1]) if cut else 0
            nxt = max(int(np.searchsorted(ends, base + SPAN_GATHER_CHUNK,
                                          side="right")), cut + 1)
            yield (byte_index(r_start[lo + cut:lo + nxt],
                              r_len[lo + cut:lo + nxt]),
                   int(ends[nxt - 1]) - base)
            cut = nxt
        if b < h_len.size:
            s, n = int(h_start[b]), int(h_len[b])
            yield slice(s, s + n), n
        lo = b + 1


def gather_spans(data: torch.Tensor, starts: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """``data[s : s + n]`` of every ``(s, n)``, concatenated in order
    (1-D ``data``; int64 ``starts`` and ``lengths`` on its device),
    through :func:`_span_pieces`: no index the size of ``data``. A
    result that is one run is a view of ``data``."""
    if lengths.numel() == 0:
        return data[:0]
    pieces = [data[key] for key, _ in _span_pieces(starts, lengths)]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def scatter_spans(dst: torch.Tensor, starts: torch.Tensor,
                  lengths: torch.Tensor, src: torch.Tensor) -> None:
    """The inverse of :func:`gather_spans`, in place: ``dst[s : s + n]``
    of every ``(s, n)`` takes the next ``n`` elements of ``src``, in
    order, with no index the size of ``dst``."""
    if lengths.numel() == 0:
        return
    pos = 0
    for key, n in _span_pieces(starts, lengths):
        dst[key] = src[pos:pos + n]
        pos += n


def cat_views(parts, device=None) -> torch.Tensor:
    """``torch.cat(parts)`` of 1-D tensors of one type; where the parts
    are consecutive pieces of one tensor's memory (the splits of one
    stream) the result is a view of that memory and nothing is copied.
    ``device`` places an empty result."""
    parts = [p for p in parts if p.numel()]
    if not parts:
        return torch.zeros(0, dtype=torch.uint8, device=device)
    first = parts[0]
    item = first.element_size()
    chained = all(
        p.is_contiguous() and p.dtype == first.dtype
        and p.device == first.device
        and p.untyped_storage().data_ptr()
        == first.untyped_storage().data_ptr()
        for p in parts) and all(
        a.data_ptr() + a.numel() * item == b.data_ptr()
        for a, b in zip(parts, parts[1:]))
    if not chained:
        return torch.cat(parts)
    total = sum(p.numel() for p in parts)
    return torch.empty(0, dtype=first.dtype, device=first.device).set_(
        first.untyped_storage(), first.storage_offset(), (total,))
