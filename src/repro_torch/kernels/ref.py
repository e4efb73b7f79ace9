"""Plain PyTorch versions of the port's kernels.

Each computes the same function as its CUDA kernel, in the kernel's
batched array-in/array-out signature. The kernel wrappers run these for
tensors on the CPU (the tests hold them against the reference's Pallas
kernels); ``chip_smoke.py`` holds each kernel against its plain version
on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch._perf_opts import perf_opts_enabled
from repro_torch.core._tensor import bits_of, wrap_int32
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


SORT_BLOCK = 4096    # words a block-sort CTA sorts (csrc/bitonic.cuh)
MERGE_CHUNK = 2048   # outputs a merge CTA writes
MERGE_ITEMS = 8      # outputs a merge thread writes


def _bitonic_network(x: torch.Tensor) -> torch.Tensor:
    """The block sort's bitonic network over the last axis (a power of
    two), in the form whose stages all ascend: stage k first pairs each
    entry i of a k-run's lower half with its mirror i ^ (k - 1), then
    strides k / 4 .. 1 pair i with i ^ j; the smaller word always goes
    to the lower index."""
    m = x.shape[-1]
    i = torch.arange(m, device=x.device)
    k = 2
    while k <= m:
        j = k // 2
        while j:
            mask = k - 1 if j == k // 2 else j
            other = x[..., i ^ mask]
            lower = (i & j) == 0
            x = torch.where(lower, torch.minimum(x, other),
                            torch.maximum(x, other))
            j //= 2
        k *= 2
    return x


def _co_rank(a: torch.Tensor, b: torch.Tensor, la: torch.Tensor,
             lb: torch.Tensor, d: torch.Tensor,
             b_at: torch.Tensor) -> torch.Tensor:
    """Merge path, by binary search: the number of a's words among the
    first ``d`` of the merge of ``a[..., :la]`` and ``b[..., b_at:b_at +
    lb]`` (words unique). ``a``, ``b``: ``[..., L]``; ``la``, ``lb``,
    ``d``, ``b_at``: int64 tensors broadcasting to ``[..., K]``, one cut
    each."""
    d, la, lb, b_at = torch.broadcast_tensors(d, la, lb, b_at)
    lo = torch.clamp(d - lb, min=0)
    hi = torch.minimum(d, la)
    while bool((lo < hi).any()):
        mid = (lo + hi) // 2
        active = lo < hi
        ai = a.gather(-1, mid.clamp(0, a.shape[-1] - 1))
        bi = b.gather(-1, (b_at + d - 1 - mid).clamp(0, b.shape[-1] - 1))
        before = active & (ai < bi)
        lo = torch.where(before, mid + 1, lo)
        hi = torch.where(active & ~before, mid, hi)
    return lo


def _merge_pass(x: torch.Tensor, run: int, chunk: int,
                items: int) -> torch.Tensor:
    """One merge launch: pairs of sorted ``run``-word runs of ``[b, n]``
    merged into runs of ``2 * run``. Each CTA writes ``chunk`` outputs
    (fewer where a pair is shorter): its two cuts by merge path, its
    slices of both runs staged side by side, and per thread the cut of
    its ``items`` outputs and a sequential merge of them."""
    b, n = x.shape
    chunk = min(chunk, 2 * run)
    items = min(items, chunk)
    threads = chunk // items
    n_pairs = n // (2 * run)
    pairs = x.reshape(b, n_pairs, 2, run)
    a, bb = pairs[:, :, 0], pairs[:, :, 1]            # [b, P, run]
    dev = x.device
    diag = torch.arange(0, 2 * run + 1, chunk, device=dev)
    zero, whole = torch.tensor(0), torch.tensor(run)
    cuts = _co_rank(a, bb, whole, whole, diag.expand(b, n_pairs, -1),
                    zero)                             # [b, P, C + 1]
    a0, na = cuts[..., :-1], cuts[..., 1:] - cuts[..., :-1]
    b0 = diag[:-1] - a0                               # [b, P, C]
    n_chunks = a0.shape[-1]
    idx = torch.arange(chunk, device=dev)
    src_a = (a0[..., None] + idx).clamp(max=run - 1)  # [b, P, C, chunk]
    src_b = (b0[..., None] + idx - na[..., None]).clamp(0, run - 1)
    ga = a.gather(-1, src_a.reshape(b, n_pairs, -1)).reshape(src_a.shape)
    gb = bb.gather(-1, src_b.reshape(b, n_pairs, -1)).reshape(src_b.shape)
    xs = torch.where(idx < na[..., None], ga, gb)     # the staged chunk
    # each thread's cut inside it: a = xs[:na], b = xs[na:]
    dt = torch.arange(threads, device=dev) * items
    na_t = na[..., None].expand(b, n_pairs, n_chunks, threads)
    lo = _co_rank(xs, xs, na_t, chunk - na_t, dt.expand_as(na_t), na_t)
    ia, ib = lo, dt - lo
    merged = []
    for _ in range(items):
        xa = xs.gather(-1, ia.clamp(max=chunk - 1))
        xb = xs.gather(-1, (na_t + ib).clamp(max=chunk - 1))
        take_a = (ib >= chunk - na_t) | ((ia < na_t) & (xa < xb))
        merged.append(torch.where(take_a, xa, xb))
        ia = ia + take_a.to(ia.dtype)
        ib = ib + (~take_a).to(ib.dtype)
    return torch.stack(merged, dim=-1).reshape(b, n)


def sort_blocks_merge_ref(offsets: torch.Tensor, lengths: torch.Tensor,
                          carry: torch.Tensor, block: int,
                          chunk: int = MERGE_CHUNK,
                          items: int = MERGE_ITEMS):
    """The algorithm of ``sort.bitonic_sort``'s CUDA kernels in plain
    PyTorch, for the CPU tests: each entry packed into one 64-bit word
    (the key above its row position: the signed view of the kernel's
    unsigned word, whose key has its sign bit flipped, so the two order
    alike), blocks of ``block`` words sorted by the bitonic network,
    merge passes with the kernel's merge-path cuts until one run is the
    row, then the offsets from the words and the carries gathered by
    position. ``block`` is a power of two <= n; the kernel takes
    ``min(n, SORT_BLOCK)``. Used by the tests only; equals
    :func:`sort_ref`."""
    b, n = offsets.shape
    if block & (block - 1) or not 1 <= block <= n:
        raise ValueError(f"block {block} must be a power of two <= {n}")
    pos = torch.arange(n, dtype=torch.int64, device=offsets.device)
    words = (offsets.to(torch.int64) << 32) | pos
    words = _bitonic_network(words.reshape(b, n // block, block))
    words = words.reshape(b, n)
    run = block
    while run < n:
        words = _merge_pass(words, run, chunk, items)
        run *= 2
    order = words & 0xFFFFFFFF
    return ((words >> 32).to(torch.int32), lengths.gather(-1, order),
            carry.gather(-1, order))


def coalesce_ref(offsets: torch.Tensor, lengths: torch.Tensor):
    """Coalesce offset-sorted ``[b, n]`` rows — the plain version of
    ``coalesce_kernel.coalesce`` in its cumsum/scatter form: run ids
    count every boundary (pads included), run heads scatter their offset
    and exclusive length prefix, run ends their inclusive prefix, and
    slots past the number of heads are padding. Ends and length sums
    wrap as int32 arithmetic does. Returns ``(offsets, lengths,
    counts)``."""
    b, n = offsets.shape
    dev = offsets.device
    off = offsets.to(torch.int64)
    ln = lengths.to(torch.int64)
    ends = wrap_int32(off + ln)          # int32 ends, as the TPU's wrap
    prev_end = torch.cat([torch.full((b, 1), -1, dtype=torch.int32,
                                     device=dev), ends[:, :-1]], dim=1)
    is_pad = off == PAD_OFFSET
    boundary = (offsets != prev_end) | is_pad
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


COALESCE_TILE = 4096   # entries a CTA of the coalesce cluster holds


def coalesce_tiled_ref(offsets: torch.Tensor, lengths: torch.Tensor,
                       tile: int = COALESCE_TILE, garbage: int = -0x5A5A5A5B):
    """The algorithm of ``coalesce``'s CUDA kernel in plain PyTorch, for
    the CPU tests: each ``[b, n]`` row cut into tiles of ``tile`` entries
    (one CTA of the row's cluster each). A tile's totals are its
    boundaries, heads, non-pad length sum and the exclusive length
    prefix at its last boundary (0 for a pad); every tile reads the
    totals of all tiles of its row, which give it its run base, length
    base, the start of the run open at its first entry (from the nearest
    earlier tile with a boundary), the row's run count and boundary
    count. Then each boundary entry writes its run's offset (its own if
    it is a head and the run id is below the run count, else padding),
    each run's last entry its length (its inclusive length prefix less
    the run's start, 0 for a pad or past the run count) through a table
    of run starts by run id, and each tile its share of the padding
    slots (as many as its non-boundary entries), counted back from the
    row's end. Sums wrap as int32. The outputs start as ``garbage``; a
    slot written never or twice raises. Equals :func:`coalesce_ref`."""
    b, n = offsets.shape
    dev = offsets.device
    off = offsets.to(torch.int64)
    ln = lengths.to(torch.int64)
    prev_end = torch.cat([torch.full((b, 1), -1, dtype=torch.int32,
                                     device=dev),
                          wrap_int32(off + ln)[:, :-1]], dim=1)
    is_pad = offsets == PAD_OFFSET
    bd = (offsets != prev_end) | is_pad
    live = torch.where(is_pad, 0, ln)
    last_of_run = torch.cat([bd[:, 1:], torch.ones((b, 1), dtype=torch.bool,
                                                   device=dev)], dim=1)
    cuts = [(c, min(n, c + tile)) for c in range(0, n, tile)]

    zero = torch.zeros((b,), dtype=torch.int64, device=dev)
    totals = []                        # what each tile publishes
    for lo, hi in cuts:
        t_bd, t_live = bd[:, lo:hi], live[:, lo:hi]
        excl = torch.cumsum(t_live, dim=1) - t_live
        pos = torch.arange(hi - lo, device=dev).expand_as(t_bd)
        last_bd = torch.where(t_bd, pos, -1).amax(dim=1, keepdim=True)
        at = last_bd.clamp(min=0)
        totals.append({"nb": t_bd.sum(dim=1),
                       "nh": (t_bd & ~is_pad[:, lo:hi]).sum(dim=1),
                       "ls": t_live.sum(dim=1), "has": last_bd[:, 0] >= 0,
                       "last_pad": is_pad[:, lo:hi].gather(1, at)[:, 0],
                       "last_excl": excl.gather(1, at)[:, 0]})
    n_runs = sum(t["nh"] for t in totals)

    sink = 2 * n                       # oo at [0, n), ol at [n, 2n)
    out = torch.full((b, sink + 1), garbage, dtype=torch.int64, device=dev)
    writes = torch.zeros((b, sink + 1), dtype=torch.int64, device=dev)

    def write(ok, slot, val):
        idx = torch.where(ok, slot, sink)
        out.scatter_(1, idx, val)
        writes.scatter_add_(1, idx, torch.ones_like(idx))

    # what a tile reads of the tiles before it in its row
    run_base, len_base, nonb_before, carry = zero, zero, zero, zero
    for (lo, hi), tot in zip(cuts, totals):
        t_bd, t_pad, t_live = bd[:, lo:hi], is_pad[:, lo:hi], live[:, lo:hi]
        local = torch.cumsum(t_bd.to(torch.int64), dim=1)   # run - base + 1
        run = run_base[:, None] + local - 1
        incl = len_base[:, None] + torch.cumsum(t_live, dim=1)
        excl = incl - t_live
        # the run-start table by local run id; 0 is the run open at the
        # tile's first entry, and the last slot takes non-boundaries
        w = hi - lo
        starts = torch.zeros((b, w + 2), dtype=torch.int64, device=dev)
        starts.scatter_(1, torch.where(t_bd, local, w + 1),
                        torch.where(t_pad, 0, excl))
        starts[:, 0] = carry
        start = starts.gather(1, local)
        past = run >= n_runs[:, None]
        write(t_bd, run, torch.where(t_pad | past, PAD_OFFSET,
                                     off[:, lo:hi]))
        write(last_of_run[:, lo:hi] & (run >= 0), n + run,
              torch.where(t_pad | past, 0,
                          wrap_int32(incl - start).to(torch.int64)))
        nonb = (~t_bd).to(torch.int64)
        first = n - nonb_before - (w - tot["nb"])
        slot = first[:, None] + torch.cumsum(nonb, dim=1) - nonb
        write(nonb.bool(), slot, torch.full_like(slot, PAD_OFFSET))
        write(nonb.bool(), n + slot, torch.zeros_like(slot))
        carry = torch.where(tot["has"], torch.where(
            tot["last_pad"], 0, len_base + tot["last_excl"]), carry)
        run_base = run_base + tot["nb"]
        len_base = len_base + tot["ls"]
        nonb_before = nonb_before + (w - tot["nb"])
    bad = writes[:, :sink] != 1
    if bool(bad.any()):
        r, slot = (int(x) for x in bad.nonzero()[0])
        raise RuntimeError(f"row {r}: output word {slot} written "
                           f"{int(writes[r, slot])} times")
    return (wrap_int32(out[:, :n]), wrap_int32(out[:, n:sink]),
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


def zero_skip_nonzero(data: torch.Tensor) -> torch.Tensor:
    """The zero-skip kernels' zero test on the bits: for a float,
    ``(bits & ~sign) != 0`` (-0.0 a zero, NaN not), else ``bits != 0``;
    the same as ``data != 0`` in the payload's type."""
    bits = bits_of(data)
    if data.dtype.is_floating_point:
        bits = bits & torch.iinfo(bits.dtype).max     # the sign cleared
    return bits != 0


def zero_skip_encode_chunked_ref(data: torch.Tensor, chunk: int,
                                 garbage: int = 0x5A):
    """The algorithm of ``zero_skip_encode``'s CUDA kernel in plain
    PyTorch, for the CPU tests: each ``[rows, n]`` row cut into chunks of
    ``chunk`` elements (the whole row where ``chunk >= n``), each chunk's
    count of nonzeros (the bit test of :func:`zero_skip_nonzero`), an
    exclusive scan of the counts over the row's chunks (what the
    look-back yields), each nonzero at slot ``chunk prefix + its rank in
    the chunk``, and each zero in the chunk's share of the padding,
    counted back from the row's end past the zeros of the chunks before
    it: slot ``n - zeros before - zeros in the chunk + its rank among
    them``. The outputs start filled with ``garbage`` bytes, so a slot
    that no chunk writes shows. Equals :func:`zero_skip_encode_ref`."""
    rows, n = data.shape
    c = min(chunk, n)
    if c < 1 or n % c:
        raise ValueError(f"chunk {chunk} must divide the row length {n}")
    nz = zero_skip_nonzero(data).reshape(rows, n // c, c).to(torch.int64)
    counts = nz.sum(dim=-1)                               # [rows, chunks]
    exclusive = torch.cumsum(counts, dim=-1) - counts
    zeros = c - counts
    zeros_before = torch.arange(0, n, c, device=data.device) - exclusive
    rank = torch.cumsum(nz, dim=-1) - nz                  # in its chunk
    zero_rank = torch.cumsum(1 - nz, dim=-1) - (1 - nz)
    slot = torch.where(nz.bool(), exclusive[..., None] + rank,
                       (n - zeros_before - zeros)[..., None] + zero_rank)
    slot = slot.reshape(rows, n)
    vals = torch.empty((rows, n), dtype=data.dtype, device=data.device)
    bits_of(vals).view(torch.uint8).fill_(garbage)
    pos = torch.full((rows, n), garbage * 0x01010101, dtype=torch.int32,
                     device=data.device)
    nonzero = nz.bool().reshape(rows, n)
    zero = torch.zeros((), dtype=bits_of(data).dtype, device=data.device)
    bits_of(vals).scatter_(1, slot, torch.where(nonzero, bits_of(data), zero))
    pos.scatter_(1, slot, torch.where(
        nonzero, torch.arange(n, dtype=torch.int32, device=data.device), -1))
    return vals, pos


def zero_skip_decode_ref(vals: torch.Tensor, pos: torch.Tensor):
    """Scatter ``(vals, pos)`` rows back into zeroed ``[rows, n]`` rows
    through a ``[rows, n + 1]`` staging buffer whose last slot takes
    ``pos == -1`` — the rle codec's decode, the plain version of
    ``fused_round.zero_skip_decode``."""
    return get_codec("rle").tensor_decode((vals, pos))


def pack_ref(offsets: torch.Tensor, lengths: torch.Tensor,
             starts: torch.Tensor, data: torch.Tensor, base,
             out_len: int) -> torch.Tensor:
    """Gather-form pack of offset-sorted, non-overlapping ``[cap]``
    requests into ``[out_len]``: position p takes the last request with
    offset <= p + base (int32 arithmetic, as on the TPU) and, where that
    request covers it, ``data[start + within]`` (clipped into ``data``),
    else 0 — the plain version of ``pack.pack``."""
    p = torch.arange(out_len, dtype=torch.int32,
                     device=offsets.device) + int(base)
    r = torch.searchsorted(offsets.contiguous(), p, right=True) - 1
    r_c = r.clamp(0, offsets.shape[0] - 1)
    within = p.to(torch.int64) - offsets[r_c].to(torch.int64)
    covered = (r >= 0) & (within < lengths[r_c])
    src = (starts[r_c].to(torch.int64) + within).clamp(0, data.shape[0] - 1)
    return torch.where(covered, data[src], torch.zeros((), dtype=data.dtype,
                                                       device=data.device))


def route_spans_ref(offsets: torch.Tensor, lengths: torch.Tensor,
                    sources: torch.Tensor, data: torch.Tensor,
                    out_len: int) -> torch.Tensor:
    """Span copy of ``[b, cap]`` rows of spans, sorted by offset and
    disjoint, out of ``[b, dcap]`` payload rows into ``[b, out_len]``:
    position p takes the last span r with offset <= p and, where
    ``p - offset[r] < length[r]``, ``data[source[r] + p - offset[r]]``
    (clipped into the row), else 0, bit for bit — the plain version of
    ``pack.route_spans``."""
    b, cap = offsets.shape
    if cap == 0:
        return torch.zeros((b, out_len), dtype=data.dtype,
                           device=data.device)
    off = offsets.to(torch.int64).contiguous()
    p = torch.arange(out_len, device=off.device).expand(b, out_len)
    r = torch.searchsorted(off, p.contiguous(), right=True) - 1
    r_c = r.clamp(0, cap - 1)
    within = p - off.gather(1, r_c)
    covered = (r >= 0) & (within < lengths.to(torch.int64).gather(1, r_c))
    src = (sources.to(torch.int64).gather(1, r_c) + within).clamp(
        0, data.shape[1] - 1)
    bits = bits_of(data)
    return torch.where(covered, bits.gather(1, src),
                       torch.zeros((), dtype=bits.dtype,
                                   device=bits.device)).view(data.dtype)


TILE = 4096   # positions a tile of the pack kernels (csrc/pack_tiles.cuh)
INT32_MAX = (1 << 31) - 1


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values as int32 arithmetic leaves them (two's complement)."""
    return ((x + (1 << 31)) % (1 << 32)) - (1 << 31)


def pack_tile_walk_ref(s_off: torch.Tensor, s_len: torch.Tensor,
                       s_st: torch.Tensor, data: torch.Tensor, base,
                       out_len: int):
    """The algorithm of the pack tile kernel (``csrc/pack_tiles.cuh``,
    ``fused_sort_pack``'s second half and ``pack``) in plain PyTorch,
    for the CPU tests, on offset-SORTED ``[b, cap]`` rows with payload
    ``[b, dcap]``: per tile of ``TILE`` positions (p = position + base in
    int32), the carry-in r0 (the last offset <= the tile's first p) and
    the run's end (the last offset <= its last p) by search; heads: each
    request of the run marks its offset's place in the tile, the last of
    equal offsets winning; an inclusive max-scan of the heads seeded
    with r0 gives every position its request r. A tile whose p wraps past
    2^31 - 1 searches per position. Then ``within = p - off[r]`` (int32),
    covered where ``r >= 0`` and ``within < len[r]``, the payload
    ``data[start[r] + within]`` (clipped into the row) and the mask.
    ``base``: an int or one per row. An ``out_len`` that is not a
    multiple of ``TILE`` ends in a ragged tile whose run ends at the
    row's last position, as ``route_spans``' kernel walks it (``pack``
    and ``fused_sort_pack`` take whole tiles). Returns ``(window,
    mask)``."""
    b, cap = s_off.shape
    dev = s_off.device
    base = torch.as_tensor(base, dtype=torch.int64, device=dev)
    base = base.reshape(-1).expand(b)[:, None]
    off = s_off.to(torch.int64).contiguous()
    idx = torch.arange(cap, device=dev)
    last_of_equal = torch.cat([off[:, 1:] != off[:, :-1],
                               torch.ones((b, 1), dtype=torch.bool,
                                          device=dev)], dim=1)
    rs = []
    for t in range(-(-out_len // TILE)):
        n = min(TILE, out_len - t * TILE)                     # ragged last
        i_tile = torch.arange(n, device=dev)
        p_first = _wrap32(t * TILE + base)                    # [b, 1]
        p = _wrap32(p_first + i_tile)                         # [b, n]
        r0 = torch.searchsorted(off, p_first, right=True) - 1
        r_end = torch.searchsorted(off, p_first + n - 1, right=True) - 1
        heads = (idx > r0) & (idx <= r_end) & last_of_equal
        slot = torch.where(heads, off - p_first, n)
        head = torch.full((b, n + 1), -1, dtype=torch.int64, device=dev)
        head.scatter_(1, slot, idx.expand(b, cap))
        walked = torch.cummax(torch.maximum(head[:, :n], r0),
                              dim=1).values
        searched = torch.searchsorted(off, p, right=True) - 1
        wraps = p_first > INT32_MAX - (TILE - 1)
        rs.append(torch.where(wraps, searched, walked))
    r = torch.cat(rs, dim=1)                                  # [b, out_len]
    p = _wrap32(torch.arange(out_len, device=dev) + base)
    r_c = r.clamp(0, cap - 1)
    within = _wrap32(p - off.gather(1, r_c))
    covered = (r >= 0) & (within < s_len.to(torch.int64).gather(1, r_c))
    src = (s_st.to(torch.int64).gather(1, r_c) + within).clamp(
        0, data.shape[1] - 1)
    zero = torch.zeros((), dtype=data.dtype, device=dev)
    win = torch.where(covered, data.gather(1, src), zero)
    mask = torch.where(covered, torch.ones((), dtype=data.dtype, device=dev),
                       zero)
    return win, mask


ATTENTION_CHUNK = 4096   # the reference's default (REPRO_PERF_OPTS on)
ATTENTION_CHUNK_PV32 = 1024   # REPRO_PERF_OPTS=0: f32 p.v


def attention_chunk(pv32: bool) -> int:
    """The plain attention's keys a chunk for a p.v variant, as the
    reference ties them to its setting."""
    return ATTENTION_CHUNK_PV32 if pv32 else ATTENTION_CHUNK


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int | None,
                        logit_cap: float | None, q_offset: int,
                        kv_len: int | None = None,
                        pv32: bool | None = None) -> torch.Tensor:
    """Chunked (flash-style) GQA attention, O(S * chunk) memory — the
    reference's ``models.layers.flash_attention`` line for line, and the
    plain version of ``flash.flash_attention_fused``. At the reference's
    default (``pv32`` False: chunk 4096) the probabilities and values
    are rounded to bf16 for the PV product, accumulated in f32; with
    ``pv32`` (chunk 1024, ``REPRO_PERF_OPTS=0`` in the reference) the
    PV product is an f32 einsum of the f32 probabilities and values, as
    the TPU kernel computes it. ``pv32=None`` follows the setting
    (``_perf_opts.perf_opts_enabled``), read at the call.

    q: ``[B, Sq, Hq, hd]``; k, v: ``[B, Skv, Hkv, hd]``. q_offset: the
    position of q[0] within the kv sequence; kv_len: the valid kv prefix
    (a decode cache), or None.
    """
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    if pv32 is None:
        pv32 = not perf_opts_enabled()
    chunk = attention_chunk(pv32)
    qr = q.reshape(b, sq, hkv, g, hd).float()
    scale = 1.0 / math.sqrt(hd)
    nchunks = -(-skv // chunk)
    pad = nchunks * chunk - skv
    kc = F.pad(k, (0, 0, 0, 0, 0, pad)).reshape(b, nchunks, chunk, hkv, hd)
    vc = F.pad(v, (0, 0, 0, 0, 0, pad)).reshape(b, nchunks, chunk, hkv, hd)
    dev = q.device
    qpos = q_offset + torch.arange(sq, device=dev)
    m = torch.full((b, sq, hkv, g), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, hkv, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, hkv, g, hd), dtype=torch.float32, device=dev)
    for cidx in range(nchunks):
        kci = kc[:, cidx].float()
        vci = vc[:, cidx].float()
        kvpos = cidx * chunk + torch.arange(chunk, device=dev)
        logits = torch.einsum("bskgd,bckd->bskgc", qr, kci) * scale
        if logit_cap is not None:
            logits = logit_cap * torch.tanh(logits / logit_cap)
        # padded keys (skv -> nchunks*chunk) must never enter the softmax
        mask = (kvpos[None, :] < skv)
        if causal:
            mask = mask & (kvpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (qpos[:, None] - kvpos[None, :] < window)
        if kv_len is not None:
            mask = mask & (kvpos[None, :] < kv_len)
        logits = torch.where(mask[None, :, None, None, :], logits, -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        probs = torch.exp(logits - m_new[..., None])
        del logits
        l = l * alpha + probs.sum(dim=-1)
        if pv32:
            pv = torch.einsum("bskgc,bckd->bskgd", probs, vci)
        else:
            # bf16 operands, f32 products and sums: the reference's
            # preferred_element_type=f32 einsum of bf16 probs and values
            pv = torch.einsum("bskgc,bckd->bskgd",
                              probs.to(torch.bfloat16).float(),
                              vci.to(torch.bfloat16).float())
        del probs
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sq, hq, hd).to(q.dtype)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            dout: torch.Tensor, *, causal: bool,
                            window: int | None, logit_cap: float | None,
                            q_offset: int, kv_len: int | None = None,
                            pv32: bool | None = None):
    """The plain backward of attention, and of the
    ``flash.flash_attention_bwd`` kernel: the autograd gradient of
    :func:`flash_attention_ref` at ``(q, k, v)`` against ``dout``, as
    ``(dq, dk, dv)`` in the inputs' types. ``out`` (the forward's
    output) is what the kernel takes; the plain version recomputes it.
    Autograd rounds to bf16 what the forward rounds: at the default p.v
    each element of dP = dout . bf16(v) and each key's dv; with ``pv32``
    nothing (None: the setting's, which the plain attention reads)."""
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} / dout "
                         f"{tuple(dout.shape)} must be shaped like q "
                         f"{tuple(q.shape)}")
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = flash_attention_ref(*leaves, causal=causal, window=window,
                                logit_cap=logit_cap, q_offset=q_offset,
                                kv_len=kv_len, pv32=pv32)
        return torch.autograd.grad(o, leaves, dout.to(o.dtype))


def tf32_split(x: torch.Tensor, lo: str = "rna"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` of f32 ``x`` as the kernels split an operand
    (``cvt.rna.tf32.f32``): hi is x rounded to TF32's 10 mantissa bits,
    to nearest with ties away from zero (add half of the 13 dropped bits
    to the magnitude and clear them, on the int32 view), lo the same
    rounding of ``x - hi`` (exact in f32), as the backward kernel takes
    it; with ``lo="trunc"`` lo is ``x - hi`` truncated to TF32, as the
    tensor core reads an f32 word it is given whole (the forward's
    ``tc_f32``). A bf16 value is exact in TF32: its lo is 0."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    def trunc(t):
        return (t.contiguous().view(torch.int32) & -0x2000) \
            .view(torch.float32)
    if lo not in ("rna", "trunc"):
        raise ValueError(f"lo {lo!r} must be 'rna' or 'trunc'")
    hi = rna(x.float())
    return hi, (rna if lo == "rna" else trunc)(x.float() - hi)


def _split_mm(a: torch.Tensor, b: torch.Tensor, terms: int,
              lo: str = "rna") -> torch.Tensor:
    """``a @ b`` as the tensor cores take it: with ``terms=3`` the split
    product ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` (the kernel skips the
    term of an operand whose lo is 0: a zero here), with ``terms=1`` the
    single TF32 product ``a_hi b_hi``. Each product of TF32 values is
    exact in f32; the sums are f32. ``lo``: the split's lo rounding
    (:func:`tf32_split`)."""
    ah, al = tf32_split(a, lo)
    bh, bl = tf32_split(b, lo)
    if terms == 1:
        return ah @ bh
    if terms != 3:
        raise ValueError(f"terms {terms} must be 1 or 3")
    return (al @ bh + ah @ bl) + ah @ bh


def flash_attention_bwd_split_ref(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, out: torch.Tensor,
                                  dout: torch.Tensor, *, causal: bool,
                                  window: int | None,
                                  logit_cap: float | None, q_offset: int,
                                  kv_len: int | None = None,
                                  terms: int = 3, logits: str = "fma",
                                  pv32: bool = False):
    """A model of the backward kernel's arithmetic
    (``csrc/flash_bwd.cu``) in plain PyTorch: the function of
    :func:`flash_attention_bwd_ref` written out (not autograd) with each
    product and sum taken as the kernel takes it, as far as PyTorch can
    say so. The tensor cores' products (:func:`_split_mm`): dP =
    dO' bf16(v)^T, dk = dS^T q, dq = dS k, and for bf16 inputs dv =
    bf16(p~)^T dO'. For f32 inputs dv is the kernel's FMA chain over the
    rows in order (each step in f64, rounded to f32). The logits q k^T:
    with ``logits="fma"`` the f32 product of :func:`flash_attention_ref`
    itself (the kernel's f32 FMA chains give the plain version's bits on
    the card, so here the logits equal the plain ones by construction),
    with ``logits="tf32"`` a tensor-core product like the others. l is
    the f64 sum of p~ = exp(x - m), rounded once. The row max is taken
    over the whole row (the plain version takes it a 4096-key chunk at
    a time), the row max's gradient dm lands on the row's first argmax
    key, and a row that sees no key gets no gradient. ``terms=1`` takes
    each tensor-core product as one TF32 product.

    Two ways it differs from the kernel: a tensor-core product here is a
    whole-K product summed by PyTorch's f32 matmul, while the kernel
    sums the terms of each 8-wide k-step in the mma (whose additions
    truncate) and adds that into f32; and an f64 step of the dv chain
    rounds twice where the FMA rounds once. With ``pv32`` the model is
    of the kernel's f32 p.v variant: nothing is rounded to bf16 (v, p~,
    dP, dv), dP's v is split like its other operand, and for bf16 inputs
    so is dv's p~. Shapes and types as
    :func:`flash_attention_bwd_ref`'s."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    scale = 1.0 / math.sqrt(hd)

    def rows(t):   # [b, sq, hq, hd] -> [b, hkv, sq * g, hd], rows s * g + h
        return (t.float().reshape(b, sq, hkv, g, hd).permute(0, 2, 1, 3, 4)
                .reshape(b, hkv, sq * g, hd))

    def bf16(t):   # the default variant's roundings; none with pv32
        return t if pv32 else t.to(torch.bfloat16).float()

    qr, o, do = rows(q), rows(out), rows(dout)
    kf = k.float().permute(0, 2, 1, 3)
    vb = bf16(v.float().permute(0, 2, 1, 3))
    if logits == "fma":
        # flash_attention_ref's einsum, chunk by padded chunk
        chunk = attention_chunk(pv32)
        nchunks = -(-skv // chunk)
        kc = F.pad(k, (0, 0, 0, 0, 0, nchunks * chunk - skv)) \
            .reshape(b, nchunks, chunk, hkv, hd)
        q5 = q.reshape(b, sq, hkv, g, hd).float()
        s = torch.cat([torch.einsum("bskgd,bckd->bskgc", q5, kc[:, c].float())
                       for c in range(nchunks)], dim=-1)[..., :skv]
        s = s.permute(0, 2, 1, 3, 4).reshape(b, hkv, sq * g, skv) * scale
    elif logits == "tf32":
        s = _split_mm(qr, kf.transpose(-1, -2), terms) * scale
    else:
        raise ValueError(f"logits {logits!r} must be 'fma' or 'tf32'")
    dcap = torch.ones_like(s)
    if logit_cap is not None:
        t = torch.tanh(s / logit_cap)
        s = logit_cap * t
        dcap = 1 - t * t
    qpos = q_offset + torch.arange(sq * g, device=dev) // g
    kvpos = torch.arange(skv, device=dev)
    key_end = skv if kv_len is None else min(kv_len, skv)
    mask = (kvpos[None, :] < key_end).expand(sq * g, skv)
    if causal:
        mask = mask & (kvpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (qpos[:, None] - kvpos[None, :] < window)
    seen = mask.any(dim=-1)
    xm = torch.where(mask, s, -math.inf)
    m = torch.where(seen, xm.amax(dim=-1), 0.0)
    arg = xm.argmax(dim=-1)   # the first of tied maxima
    pt = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = pt.double().sum(dim=-1).float()
    dos = torch.where(seen[:, None], do / l.clamp(min=1e-30)[..., None], 0.0)
    dd = (dos * o).sum(dim=-1)
    dp = bf16(_split_mm(dos, vb.transpose(-1, -2), terms))
    gr = pt * (dp - dd[..., None])
    dm = -gr.sum(dim=-1)
    at_max = F.one_hot(arg, skv).bool() & seen[:, None]
    ds = (gr + torch.where(at_max, dm[..., None], 0.0)) * dcap
    dq = _split_mm(ds, kf, terms) * scale
    dk = _split_mm(ds.transpose(-1, -2), qr, terms) * scale
    if q.dtype == torch.bfloat16:
        dv = _split_mm(bf16(pt).transpose(-1, -2), dos, terms)
    else:   # an FMA chain over the rows, each step in f64
        pb = bf16(pt).double()
        dv = torch.zeros((b, hkv, skv, hd), device=dev)
        for r in range(sq * g):
            dv = (pb[:, :, r, :, None] * dos[:, :, r, None, :].double()
                  + dv.double()).float()
    dv = bf16(dv)

    def unrows(t):
        return (t.reshape(b, hkv, sq, g, hd).permute(0, 2, 1, 3, 4)
                .reshape(b, sq, hq, hd))
    return (unrows(dq).to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def flash_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool,
                              window: int | None, logit_cap: float | None,
                              q_offset: int, kv_len: int | None = None,
                              n_chunks: int, tile: int = 64,
                              pv32: bool = False) -> torch.Tensor:
    """The algorithm of ``flash``'s ``split_decode`` route in plain
    PyTorch: the keys some query sees, ``[lo, hi)``, cut into
    ``n_chunks`` chunks of whole ``tile``-key tiles; per chunk a partial
    (m, l, acc) in f32 (probabilities and values rounded to bf16 for
    p.v, l from the unrounded probabilities; a chunk with no key
    m = -1e30, l = 0, acc = 0); then the merge ``m = max m_c``,
    ``l = sum l_c e^(m_c - m)``, ``out = sum acc_c e^(m_c - m) / l``.
    The same function as :func:`flash_attention_ref` for every row with
    a visible key. With ``pv32`` the kernel's f32 p.v variant: p as
    ``bf16(p) + bf16(p - bf16(p))``, two bf16 products against the bf16
    values (exact for bf16 inputs). Shapes as there."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    key_end = skv if kv_len is None else min(kv_len, skv)
    hi = min(key_end, q_offset + sq) if causal else key_end
    lo = max(0, q_offset - window + 1) if window is not None else 0
    span = max(hi - lo, 0)
    per = -(-(-(-span // n_chunks)) // tile) * tile
    qr = q.reshape(b, sq, hkv, g, hd).float()
    qpos = q_offset + torch.arange(sq, device=dev)
    scale = 1.0 / math.sqrt(hd)
    ms, ls, accs = [], [], []
    for c in range(n_chunks):
        c_lo = lo + c * per
        c_hi = min(hi, c_lo + per)
        if c_hi <= c_lo:
            ms.append(torch.full((b, sq, hkv, g), -1e30, device=dev))
            ls.append(torch.zeros((b, sq, hkv, g), device=dev))
            accs.append(torch.zeros((b, sq, hkv, g, hd), device=dev))
            continue
        kvpos = torch.arange(c_lo, c_hi, device=dev)
        logits = torch.einsum("bskgd,bckd->bskgc", qr,
                              k[:, c_lo:c_hi].float()) * scale
        if logit_cap is not None:
            logits = logit_cap * torch.tanh(logits / logit_cap)
        mask = torch.ones((sq, c_hi - c_lo), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (kvpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (qpos[:, None] - kvpos[None, :] < window)
        logits = torch.where(mask[None, :, None, None, :], logits, -1e30)
        m = logits.amax(dim=-1)
        probs = torch.exp(logits - m[..., None])
        ms.append(m)
        ls.append(probs.sum(dim=-1))
        vb = v[:, c_lo:c_hi].to(torch.bfloat16).float()
        p_hi = probs.to(torch.bfloat16).float()
        acc = torch.einsum("bskgc,bckd->bskgd", p_hi, vb)
        if pv32:
            acc = acc + torch.einsum(
                "bskgc,bckd->bskgd",
                (probs - p_hi).to(torch.bfloat16).float(), vb)
        accs.append(acc)
    m_c = torch.stack(ms)
    w = torch.exp(m_c - m_c.amax(dim=0))
    l = (torch.stack(ls) * w).sum(dim=0)
    acc = (torch.stack(accs) * w[..., None]).sum(dim=0)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sq, hq, hd).to(q.dtype)


# (query, head) rows a CTA of route tc_f32 and keys a tile of it: the
# kernel's F32Tile::kRows and kKeys (csrc/flash.cu), which the model's
# walk must follow and flash._route sizes the grid by
F32_ROWS = 64
F32_KEYS = 32


def flash_attention_tc_f32_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool,
                               window: int | None, logit_cap: float | None,
                               q_offset: int, kv_len: int | None = None,
                               terms: int = 3,
                               pv32: bool = False) -> torch.Tensor:
    """A model of the arithmetic of ``flash``'s ``tc_f32`` route in plain
    PyTorch: rows ``s * g + h`` of each (batch, kv head) in blocks of
    ``F32_ROWS``, each block walking the ``F32_KEYS``-key tiles some row
    of it can see; the logits q . k as tensor-core products
    (:func:`_split_mm`: ``terms=3`` the split TF32 product with lo given
    to the tensor core whole, ``terms=1`` a single TF32 one), scaled,
    softcapped through the cap's f32 reciprocal and masked (-1e30) as
    the kernel does; the online
    softmax tile by tile in f32, l from the unrounded p; p.v of p and v
    rounded to bf16, summed in f32; out = acc / max(l, 1e-30). The
    kernel sums each product over the head dim in 8-wide mma steps and
    l per lane; here PyTorch's matmul and sum take other orders. Equal
    to :func:`flash_attention_ref`'s function for every row that sees a
    key; a row that sees none gives what its block's walk leaves. With
    ``pv32`` p.v is the kernel's f32 variant, the split TF32 product of
    the f32 p and v (:func:`_split_mm`, lo rounded). Shapes as there; f32 out."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    n_rows = sq * g
    key_end = skv if kv_len is None else min(kv_len, skv)
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    inv_cap = None if logit_cap is None else \
        torch.tensor(1.0 / logit_cap, dtype=torch.float32)
    n_tiles = -(-max(skv, 1) // F32_KEYS)
    pad = n_tiles * F32_KEYS - skv
    qr = (q.float().reshape(b, sq, hkv, g, hd).permute(0, 2, 1, 3, 4)
          .reshape(b, hkv, n_rows, hd))
    kp = F.pad(k.float().permute(0, 2, 1, 3), (0, 0, 0, pad))
    vp = F.pad(v.float().permute(0, 2, 1, 3), (0, 0, 0, pad))
    if not pv32:
        vp = vp.to(torch.bfloat16).float()
    keep = (torch.arange(n_tiles * F32_KEYS, device=dev) < key_end)
    kp, vp = kp * keep[:, None], vp * keep[:, None]   # zero past key_end
    out = torch.empty((b, hkv, n_rows, hd), dtype=torch.float32, device=dev)
    for r0 in range(0, n_rows, F32_ROWS):
        r1 = min(r0 + F32_ROWS, n_rows)
        s_first, s_last = r0 // g, (r1 - 1) // g
        hi = min(key_end, q_offset + s_last + 1) if causal else key_end
        lo = max(0, q_offset + s_first - window + 1) if window else 0
        t_lo = lo // F32_KEYS
        t_hi = -(-hi // F32_KEYS) if hi > lo else t_lo
        qpos = q_offset + torch.arange(r0, r1, device=dev) // g
        m = torch.full((b, hkv, r1 - r0), -1e30, device=dev)
        l = torch.zeros((b, hkv, r1 - r0), device=dev)
        acc = torch.zeros((b, hkv, r1 - r0, hd), device=dev)
        for t in range(t_lo, t_hi):
            c0, c1 = t * F32_KEYS, (t + 1) * F32_KEYS
            x = _split_mm(qr[:, :, r0:r1], kp[:, :, c0:c1].transpose(-1, -2),
                          terms, lo="trunc") * scale
            if logit_cap is not None:
                x = logit_cap * torch.tanh(x * inv_cap)
            kvpos = torch.arange(c0, c1, device=dev)
            ok = (kvpos[None, :] < key_end).expand(r1 - r0, F32_KEYS)
            if causal:
                ok = ok & (kvpos[None, :] <= qpos[:, None])
            if window:
                ok = ok & (qpos[:, None] - kvpos[None, :] < window)
            x = torch.where(ok, x, -1e30)
            m_new = torch.maximum(m, x.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(x - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            pv = _split_mm(p, vp[:, :, c0:c1], 3) if pv32 else \
                p.to(torch.bfloat16).float() @ vp[:, :, c0:c1]
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[:, :, r0:r1] = acc / torch.clamp(l[..., None], min=1e-30)
    return (out.reshape(b, hkv, sq, g, hd).permute(0, 2, 1, 3, 4)
            .reshape(b, sq, hq, hd))
