"""Plain PyTorch versions of the port's kernels.

Each computes the same function as its CUDA kernel, in the kernel's
batched array-in/array-out signature. The kernel wrappers run these for
tensors on the CPU (the tests hold them against the reference's Pallas
kernels); ``chip_smoke.py`` holds each kernel against its plain version
on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.codec import get_codec
from repro_torch.core.coalesce import pack_data
from repro_torch.core.exchange import sort_with
from repro_torch.core.requests import PAD_OFFSET, RequestList


def sort_ref(offsets: torch.Tensor, lengths: torch.Tensor,
             carry: torch.Tensor):
    """Sort ``[b, n]`` rows by offset (stable), carrying lengths and
    ``carry`` — the plain version of ``sort.bitonic_sort``."""
    order = torch.argsort(offsets, dim=-1, stable=True)
    return (offsets.gather(-1, order), lengths.gather(-1, order),
            carry.gather(-1, order))


def coalesce_ref(offsets: torch.Tensor, lengths: torch.Tensor):
    """Coalesce offset-sorted ``[b, n]`` rows — the plain version of
    ``coalesce_kernel.coalesce`` in its cumsum/scatter form: run ids
    count every boundary (pads included), run heads scatter their offset
    and exclusive length prefix, run ends their inclusive prefix, and
    slots past the number of heads are padding. Returns
    ``(offsets, lengths, counts)``."""
    b, n = offsets.shape
    dev = offsets.device
    off = offsets.to(torch.int64)
    ln = lengths.to(torch.int64)
    ends = off + ln
    prev_end = torch.cat([torch.full((b, 1), -1, dtype=torch.int64,
                                     device=dev), ends[:, :-1]], dim=1)
    is_pad = off == PAD_OFFSET
    boundary = (off != prev_end) | is_pad
    run = torch.cumsum(boundary.to(torch.int64), dim=1) - 1
    ln_live = torch.where(is_pad, 0, ln)
    csum = torch.cumsum(ln_live, dim=1)
    is_head = boundary & ~is_pad
    next_boundary = torch.cat([boundary[:, 1:],
                               torch.ones((b, 1), dtype=torch.bool,
                                          device=dev)], dim=1)
    is_last = next_boundary & ~is_pad
    sink = n                       # dropped: one slot past the row
    head_idx = torch.where(is_head & (run >= 0), run, sink)
    last_idx = torch.where(is_last & (run >= 0), run, sink)
    run_off = torch.full((b, n + 1), PAD_OFFSET, dtype=torch.int64,
                         device=dev).scatter_(1, head_idx, off)
    run_start = torch.zeros((b, n + 1), dtype=torch.int64,
                            device=dev).scatter_(1, head_idx, csum - ln_live)
    run_end = torch.zeros((b, n + 1), dtype=torch.int64,
                          device=dev).scatter_(1, last_idx, csum)
    n_runs = is_head.sum(dim=1)
    valid = torch.arange(n, device=dev) < n_runs.unsqueeze(1)
    return (torch.where(valid, run_off[:, :n], PAD_OFFSET).to(torch.int32),
            torch.where(valid, (run_end - run_start)[:, :n], 0)
            .to(torch.int32),
            n_runs.to(torch.int32))


def fused_sort_pack_ref(offsets: torch.Tensor, lengths: torch.Tensor,
                        starts: torch.Tensor, data: torch.Tensor, base,
                        out_len: int):
    """Sort each ``[b, cap]`` row by offset, then pack the window and
    its coverage mask — ``sort_with`` plus two ``pack_data``, the plain
    version of ``fused_round.fused_sort_pack``. ``base`` is an int or
    one int per row. Returns ``(window, mask)``, ``[b, out_len]`` in
    the data's type."""
    count = torch.zeros(offsets.shape[:-1], dtype=torch.int32,
                        device=offsets.device)
    sorted_r, sorted_st = sort_with(RequestList(offsets, lengths, count),
                                    starts)
    win = pack_data(sorted_r, sorted_st, data, out_len, base=base)
    mask = pack_data(sorted_r, sorted_st, torch.ones_like(data), out_len,
                     base=base)
    return win, mask


def zero_skip_encode_ref(data: torch.Tensor):
    """Per ``[rows, n]`` row: the nonzeros (``data != 0`` in the row's
    type) compacted to the front in position order, their positions
    beside them, ``(0, -1)`` behind — the rle codec's stable-partition
    compaction, the plain version of ``fused_round.zero_skip_encode``.
    Returns ``(vals, pos int32)``."""
    (vals, pos), _ = get_codec("rle").tensor_encode(data, ())
    return vals, pos


def zero_skip_decode_ref(vals: torch.Tensor, pos: torch.Tensor):
    """Scatter ``(vals, pos)`` rows back into zeroed ``[rows, n]`` rows
    through a ``[rows, n + 1]`` staging buffer whose last slot takes
    ``pos == -1`` — the rle codec's decode, the plain version of
    ``fused_round.zero_skip_decode``."""
    return get_codec("rle").tensor_decode((vals, pos))
