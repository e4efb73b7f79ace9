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

Every helper works on the LAST axis and treats leading axes as a batch.
"""
from __future__ import annotations

import torch


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
    out.scatter_(0, flat_idx, vals.reshape(-1).to(dtype))
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
