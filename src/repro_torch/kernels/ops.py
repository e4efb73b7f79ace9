"""Public wrappers around the port's kernels (port of
``repro.kernels.ops``).

They pad request lists to power-of-two blocks, integrate with
:class:`RequestList`, chunk lists longer than one block, and keep every
leading axis as a batch of rows. Each kernel runs its plain version for
CPU tensors and launches on CUDA tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.requests import PAD_OFFSET, RequestList
from repro_torch.kernels import coalesce_kernel, fused_round
from repro_torch.kernels import sort as sort_mod


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


def _pad_block(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    """Pad the last axis to ``n`` with ``fill``; always contiguous."""
    pad = n - x.shape[-1]
    if pad == 0:
        return x.contiguous()
    return F.pad(x, (0, pad), value=fill).contiguous()


def _merge_sorted_blocks(keys: torch.Tensor) -> torch.Tensor:
    """Stable k-way merge of ``[b, nb, m]`` rows of sorted blocks.

    Returns the gather order over the flattened ``[b, nb * m]`` row that
    equals ``argsort(flat, stable=True)``: an entry's final position is
    its index in its own block plus, in every earlier block, the entries
    <= its key and, in every later block, the entries < its key.
    """
    b, nb, m = keys.shape
    rank = torch.arange(m, device=keys.device).expand(b, nb, m).clone()
    for other in range(nb):
        seq = keys[:, other].contiguous()
        for blk in range(nb):
            if blk == other:
                continue
            rank[:, blk] += torch.searchsorted(
                seq, keys[:, blk].contiguous(), right=other < blk)
    flat_rank = rank.reshape(b, nb * m)
    src = torch.arange(nb * m, device=keys.device).expand(b, nb * m)
    return torch.empty_like(flat_rank).scatter_(1, flat_rank, src)


def sort_requests_with(r: RequestList, starts: torch.Tensor):
    """Kernel-backed ``exchange.sort_with(r, starts)``.

    Lists longer than one block are chunk-sorted by the kernel and
    merged with a stable k-way merge of the sorted blocks.
    """
    cap = r.capacity
    lead = r.offsets.shape[:-1]
    off2 = r.offsets.reshape(-1, cap)
    ln2 = r.lengths.reshape(-1, cap)
    st2 = starts.reshape(-1, cap)
    n = _next_pow2(cap)
    if n <= sort_mod.MAX_BLOCK:
        so, sl, ss = sort_mod.bitonic_sort(_pad_block(off2, n, PAD_OFFSET),
                                           _pad_block(ln2, n, 0),
                                           _pad_block(st2, n, 0))
    else:
        block = sort_mod.MAX_BLOCK
        nb = -(-cap // block)
        rows = off2.shape[0]
        so, sl, ss = sort_mod.bitonic_sort(
            _pad_block(off2, nb * block, PAD_OFFSET).reshape(-1, block),
            _pad_block(ln2, nb * block, 0).reshape(-1, block),
            _pad_block(st2, nb * block, 0).reshape(-1, block))
        so, sl, ss = (x.reshape(rows, nb * block) for x in (so, sl, ss))
        order = _merge_sorted_blocks(so.reshape(rows, nb, block))
        so, sl, ss = (x.gather(1, order) for x in (so, sl, ss))
    shape = (*lead, cap)
    return (RequestList(so[:, :cap].reshape(shape),
                        sl[:, :cap].reshape(shape), r.count),
            ss[:, :cap].reshape(shape))


def coalesce(r: RequestList) -> RequestList:
    """Kernel-backed ``coalesce.coalesce_sorted``."""
    cap = r.capacity
    lead = r.offsets.shape[:-1]
    n = _next_pow2(cap)
    co, cl, cnt = coalesce_kernel.coalesce(
        _pad_block(r.offsets.reshape(-1, cap), n, PAD_OFFSET),
        _pad_block(r.lengths.reshape(-1, cap), n, 0))
    shape = (*lead, cap)
    return RequestList(co[:, :cap].reshape(shape),
                       cl[:, :cap].reshape(shape), cnt.reshape(lead))


def fused_drain_pack(r: RequestList, starts: torch.Tensor,
                     data: torch.Tensor, base, out_len: int):
    """Kernel-backed drain: ``sort_with`` + two ``pack_data`` in one
    ``fused_round.fused_sort_pack`` call.

    Takes the UNSORTED merged request lists ``[..., cap]`` with payload
    rows ``[..., dcap]`` and a base per row (or one int); returns
    ``(window, mask)``, both ``[..., out_len]`` in ``data.dtype``.
    """
    cap = r.capacity
    lead = r.offsets.shape[:-1]
    n = _next_pow2(cap)
    padded_out = -(-out_len // fused_round.TILE) * fused_round.TILE
    if isinstance(base, torch.Tensor):
        base = base.reshape(-1)
    win, mask = fused_round.fused_sort_pack(
        _pad_block(r.offsets.reshape(-1, cap), n, PAD_OFFSET),
        _pad_block(r.lengths.reshape(-1, cap), n, 0),
        _pad_block(starts.reshape(-1, cap), n, 0),
        data.reshape(-1, data.shape[-1]).contiguous(), base, padded_out)
    shape = (*lead, out_len)
    return (win[:, :out_len].reshape(shape),
            mask[:, :out_len].reshape(shape))


def rle_zero_skip_encode(data: torch.Tensor):
    """Kernel-backed ``RleCodec.tensor_encode`` compaction
    (``fused_round.zero_skip_encode``): pads rows to a power of two with
    zeros, compacts, slices back. Returns ``(vals, pos)`` in the codec's
    wire layout, with every leading axis of ``data`` kept."""
    lead, cap = data.shape[:-1], data.shape[-1]
    n = _next_pow2(cap)
    vals, pos = fused_round.zero_skip_encode(
        _pad_block(data.reshape(-1, cap), n, 0))
    return (vals[:, :cap].reshape(*lead, cap),
            pos[:, :cap].reshape(*lead, cap))


def rle_zero_skip_decode(parts) -> torch.Tensor:
    """Kernel-backed ``RleCodec.tensor_decode``
    (``fused_round.zero_skip_decode``): pads the ``(vals, pos)`` rows to
    a power of two (pos padding -1, the drop sentinel), scatters, slices
    back to the window shape."""
    vals, pos = parts
    lead, cap = vals.shape[:-1], vals.shape[-1]
    n = _next_pow2(cap)
    out = fused_round.zero_skip_decode(
        _pad_block(vals.reshape(-1, cap), n, 0),
        _pad_block(pos.reshape(-1, cap), n, -1))
    return out[:, :cap].reshape(*lead, cap)
