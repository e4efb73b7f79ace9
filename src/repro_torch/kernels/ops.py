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

from repro_torch import _cost
from repro_torch._perf_opts import perf_opts_enabled
from repro_torch.core._tensor import stable_partition_order
from repro_torch.core.requests import PAD_OFFSET, RequestList
from repro_torch.kernels import coalesce_kernel, flash, fused_round
from repro_torch.kernels import pack as pack_mod
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
        # block ``other`` counted into every earlier block (its entries <
        # their keys) and every later one (its entries <= their keys), each
        # side in one search
        seq = keys[:, other].contiguous()
        if other > 0:
            rank[:, :other] += torch.searchsorted(
                seq, keys[:, :other].reshape(b, other * m).contiguous()
            ).view(b, other, m)
        if other < nb - 1:
            later = nb - other - 1
            rank[:, other + 1:] += torch.searchsorted(
                seq, keys[:, other + 1:].reshape(b, later * m).contiguous(),
                right=True).view(b, later, m)
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


def _coalesce_pass(off: torch.Tensor, ln: torch.Tensor, shift: int):
    """One kernel pass over the blocks of ``[b, n]`` rows that start at
    ``shift`` (the entries before the first and after the last whole
    block are left as they are), then the row's runs compacted to its
    front in order. Returns ``(offsets, lengths, counts)``."""
    rows, n = off.shape
    block = coalesce_kernel.MAX_BLOCK
    span = (n - shift) // block * block
    end = shift + span
    co, cl, cnt = coalesce_kernel.coalesce(
        off[:, shift:end].reshape(-1, block).contiguous(),
        ln[:, shift:end].reshape(-1, block).contiguous())
    live = torch.cat([
        off[:, :shift] != PAD_OFFSET,
        (torch.arange(block, device=off.device)
         < cnt.unsqueeze(-1)).reshape(rows, span),
        off[:, end:] != PAD_OFFSET], dim=1)
    order = stable_partition_order(live)
    count = live.sum(dim=1)
    keep = torch.arange(n, device=off.device) < count.unsqueeze(-1)
    out_off = torch.cat([off[:, :shift], co.reshape(rows, span),
                         off[:, end:]], dim=1).gather(1, order)
    out_len = torch.cat([ln[:, :shift], cl.reshape(rows, span),
                         ln[:, end:]], dim=1).gather(1, order)
    return (torch.where(keep, out_off, PAD_OFFSET),
            torch.where(keep, out_len, 0), count)


def _coalesce_rows(off: torch.Tensor, ln: torch.Tensor):
    """``coalesce_kernel.coalesce`` for ``[b, n]`` rows of any power-of-two
    length. A row longer than one block takes kernel passes over its
    blocks, each compacting the row's runs to its front, so the runs
    left to merge meet only across block edges. The passes' blocks start
    at 0 and at half a block in turn, so every adjacent pair shares a
    block in one of them; they go on until the runs fit in one block
    (a last pass over them all) or two passes in a row merge nothing.
    Merging runs in any order gives the single pass's runs, int32 wrap
    included (a run ends where its last request ends). Such rows must
    hold their padding at the tail and no offset of -1: the kernel
    drops a run that starts a row at -1, and a block edge can fall on
    any position."""
    rows, n = off.shape
    block = coalesce_kernel.MAX_BLOCK
    if n <= block:
        return coalesce_kernel.coalesce(off, ln)
    pad = off == PAD_OFFSET
    if bool((pad[:, :-1] & ~pad[:, 1:]).any() or (off == -1).any()):
        raise ValueError(
            f"coalesce of rows longer than {block} takes padding only at "
            "a row's tail and no offset of -1")
    count = (~pad).sum(dim=1)
    idle, shift = 0, 0
    while idle < 2:
        m = int(count.max().item())
        if m <= block:
            k = _next_pow2(m)
            co, cl, cnt = coalesce_kernel.coalesce(off[:, :k].contiguous(),
                                                   ln[:, :k].contiguous())
            return (_pad_block(co, n, PAD_OFFSET), _pad_block(cl, n, 0),
                    cnt)
        off, ln, new = _coalesce_pass(off, ln, shift)
        idle = idle + 1 if torch.equal(new, count) else 0
        count, shift = new, block // 2 - shift
    return off, ln, count.to(torch.int32)


def coalesce(r: RequestList) -> RequestList:
    """Kernel-backed ``coalesce.coalesce_sorted``."""
    cap = r.capacity
    lead = r.offsets.shape[:-1]
    n = _next_pow2(cap)
    co, cl, cnt = _coalesce_rows(
        _pad_block(r.offsets.reshape(-1, cap), n, PAD_OFFSET),
        _pad_block(r.lengths.reshape(-1, cap), n, 0))
    shape = (*lead, cap)
    return RequestList(co[:, :cap].reshape(shape),
                       cl[:, :cap].reshape(shape), cnt.reshape(lead))


def pack(r: RequestList, starts: torch.Tensor, data: torch.Tensor, base,
         out_len: int) -> torch.Tensor:
    """Kernel-backed ``coalesce.pack_data`` for one offset-sorted,
    non-overlapping ``[cap]`` request list (``pack.pack``): pads the list
    to a power of two and the output to whole tiles, returns exactly
    ``[out_len]``."""
    cap = _next_pow2(r.capacity)
    padded_out = -(-out_len // pack_mod.TILE) * pack_mod.TILE
    out = pack_mod.pack(_pad_block(r.offsets, cap, PAD_OFFSET),
                        _pad_block(r.lengths, cap, 0),
                        _pad_block(starts, cap, 0), data.contiguous(), base,
                        padded_out)
    return out[:out_len]


def route_spans(offsets: torch.Tensor, lengths: torch.Tensor,
                sources: torch.Tensor, data: torch.Tensor,
                out_len: int) -> torch.Tensor:
    """Kernel-backed span copy (``pack.route_spans``) over ``[..., cap]``
    int32 span lists and ``[..., dcap]`` payload rows, every leading axis
    a batch of rows; returns ``[..., out_len]``."""
    lead, cap = offsets.shape[:-1], offsets.shape[-1]
    out = pack_mod.route_spans(
        offsets.reshape(-1, cap).contiguous(),
        lengths.reshape(-1, cap).contiguous(),
        sources.reshape(-1, cap).contiguous(),
        data.reshape(-1, data.shape[-1]).contiguous(), out_len)
    return out.view(*lead, out_len)


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


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    logit_cap: float | None = None, q_offset: int = 0,
                    kv_len: int | None = None) -> torch.Tensor:
    """Any-shape wrapper over the fused attention, the model's attention
    on the card. The reference's wrapper pads Sq/Skv to the Pallas block
    sizes; the Hopper kernel's tiles take ragged edges, so this one calls
    ``flash.flash_attention_ragged`` on the tensors as they are (a decode
    step reads its cache in place) and bounds the real keys with
    ``kv_len`` (``Skv``, or the caller's smaller valid prefix, as in a
    decode cache). Where autograd records and an input requires grad,
    the call goes through ``flash.FlashAttention``, whose backward is
    the backward kernel. CPU tensors run the plain version; ``meta``
    tensors (a dry-run's trace) give the output's shape and type alone.
    An active ``launch.op_analysis`` counter counts the call by formula
    and nothing inside it, so the count is the same whatever runs it.
    The p.v variant follows ``REPRO_PERF_OPTS`` (read once a call, as
    the reference's attention reads it): off, every route and the
    backward take their f32 p.v variant (``pv32``)."""
    _cost.count_attention(q, k, causal=causal, window=window,
                          q_offset=q_offset, kv_len=kv_len)
    pv32 = not perf_opts_enabled()
    with _cost.uncounted():
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return flash.FlashAttention.apply(q, k, v, causal, window,
                                              logit_cap, q_offset, kv_len,
                                              pv32)
        if q.device.type == "meta":
            return torch.empty_like(q)
        return flash.flash_attention_ragged(
            q, k, v, causal=causal, window=window, logit_cap=logit_cap,
            q_offset=q_offset, kv_len=kv_len, pv32=pv32)
