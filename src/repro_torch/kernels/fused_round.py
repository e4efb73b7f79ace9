"""The fused per-round kernels: the port of
``repro.kernels.fused_round`` (``fused_sort_pack``,
``zero_skip_encode``, ``zero_skip_decode``).

Each round every aggregator drains one cb window: sort the merged
request list by offset, then pack the window payload AND its coverage
mask, each position from the last request whose offset is at or before
it. The TPU kernel sorts once and keeps the sorted metadata in VMEM
scratch across its sequential grid; CUDA blocks run concurrently, so the
Hopper version (``csrc/fused_round.cu``) is several launches behind one
call: the sort of ``sort.bitonic_sort`` (block sorts and merges, many
CTAs a row) into scratch, then a tile kernel over ``(out_len / TILE,
rows)`` in which each tile walks the sorted list once (two searches,
heads in shared memory, a max-scan). Batched: ``[B, cap]`` lists give
``[B, out_len]`` windows. On a CPU tensor the wrapper runs the plain
version, :func:`repro_torch.kernels.ref.fused_sort_pack_ref`.

The rle codec's wire form on the slow hop is a zero-skip compaction of
each payload row. The TPU kernels hold a whole row in VMEM; a row of
131072 or 262144 elements does not fit a Hopper block's shared memory,
so ``csrc/zero_skip.cu`` encodes rows in tiles: one CTA a row where the
rows give every SM a CTA, else chunks of one tile that CTAs chain by a
decoupled look-back (:func:`encode_chunks`), each tile writing its share
of the padding back from the row's end. It decodes in two launches
spread over the whole card whatever the number of rows: zero the
output, then scatter every tile of ``(vals, pos)`` entries. Both take
1-, 2-, 4- and 8-byte payloads (integers, bool, float16, bfloat16,
float32, float64).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (fused_sort_pack_ref,
                                    zero_skip_decode_ref,
                                    zero_skip_encode_ref)
from repro_torch.kernels.sort import word_scratch

MAX_REQ_BLOCK = 32768
TILE = 4096
MAX_ROWS = 65535   # the tile kernel's grid y


def _one_bits(dtype) -> int:
    """The little-endian bit pattern of 1 in ``dtype``."""
    raw = torch.ones(1, dtype=dtype).view(torch.uint8).tolist()
    return int.from_bytes(bytes(raw), "little")


def fused_sort_pack(offsets: torch.Tensor, lengths: torch.Tensor,
                    starts: torch.Tensor, data: torch.Tensor, base,
                    out_len: int):
    """Sort + dual-pack drain windows in one call.

    offsets/lengths/starts: int32 ``[B, cap]`` (or ``[cap]``), UNSORTED,
    cap a power of two <= MAX_REQ_BLOCK, PAD_OFFSET/0 padding. data:
    ``[B, dcap]`` payload rows starts[] point into. base: the window's
    domain offset, an int or int32 ``[B]``. Returns ``(window, mask)``,
    ``[B, out_len]`` in ``data.dtype``. CUDA tensors launch the kernels
    (one count in ``fused_sort_pack.launches`` per call); CPU tensors
    run ``fused_sort_pack_ref``.
    """
    if offsets.dim() == 1:
        win, mask = fused_sort_pack(offsets[None], lengths[None],
                                    starts[None], data[None], base, out_len)
        return win[0], mask[0]
    b, cap = offsets.shape
    if lengths.shape != offsets.shape or starts.shape != offsets.shape \
            or data.dim() != 2 or data.shape[0] != b:
        raise ValueError("fused_sort_pack takes [B, cap] metadata and "
                         "[B, dcap] data")
    if cap & (cap - 1) or cap > MAX_REQ_BLOCK:
        raise ValueError(
            f"request block {cap} must be a power of two <= {MAX_REQ_BLOCK}")
    if out_len % TILE:
        raise ValueError(f"out_len must be a multiple of {TILE}")
    if offsets.device.type == "cpu":
        return fused_sort_pack_ref(offsets, lengths, starts, data, base,
                                   out_len)
    if b > MAX_ROWS:
        raise ValueError(f"fused_sort_pack takes at most {MAX_ROWS} rows")
    if isinstance(base, torch.Tensor):
        base_rows = base.to(dtype=torch.int32).expand(b).contiguous()
    else:
        base_rows = torch.full((b,), int(base), dtype=torch.int32,
                               device=offsets.device)
    build.require_cuda("fused_sort_pack", offsets, lengths, starts,
                       base_rows, dtype=torch.int32)
    build.require_cuda("fused_sort_pack", offsets, data)
    scratch = tuple(torch.empty_like(offsets) for _ in range(3))
    words = word_scratch(b, cap, offsets.device)
    win = torch.empty((b, out_len), dtype=data.dtype, device=data.device)
    mask = torch.empty_like(win)
    lib = build.load_library()
    with torch.cuda.device(offsets.device):
        rc = lib.repro_fused_sort_pack(
            offsets.data_ptr(), lengths.data_ptr(), starts.data_ptr(),
            data.data_ptr(), base_rows.data_ptr(),
            *(s.data_ptr() for s in scratch), words.data_ptr(),
            win.data_ptr(), mask.data_ptr(), b, cap, data.shape[1], out_len,
            data.element_size(), _one_bits(data.dtype),
            build.stream_of(offsets))
    build.check(lib, "fused_sort_pack", rc)
    fused_sort_pack.launches += 1
    return win, mask


fused_sort_pack.launches = 0

ENCODE_TILE = 4096          # elements an encode tile (csrc/zero_skip.cu)


def zero_skip_kind(name: str, dtype) -> tuple[int, bool]:
    """``(element width, float zero test)`` the zero-skip kernels take
    for ``dtype``: integers and bool of 1, 2, 4 or 8 bytes (bits != 0)
    and float16, bfloat16, float32 and float64 ((bits & ~sign) != 0, so
    -0.0 is a zero and NaN is not: ``v != 0`` in the payload's type).
    Raises ``TypeError`` for the rest: complex (a zero test on two
    parts) and the 1-byte floats (some have no -0.0 and a NaN where it
    would be)."""
    width = dtype.itemsize
    if dtype.is_complex or width not in (1, 2, 4, 8) \
            or (dtype.is_floating_point and width == 1):
        raise TypeError(f"{name} takes 1-, 2-, 4- and 8-byte integers and "
                        f"bool and 2-, 4- and 8-byte floats, got {dtype}")
    return width, dtype.is_floating_point


def encode_chunks(rows: int, n: int, sms: int) -> int:
    """Chunks a row for ``zero_skip_encode``: one, walked in tiles by one
    CTA, where the rows give every SM a CTA or a row is one tile; else
    one tile a chunk, so that rows x chunks CTAs fill several waves of
    the card. (At 256 rows of 262144 one CTA a row, no look-back, ran
    faster on the H100 than 64 chunks a row.)"""
    if n <= ENCODE_TILE or rows >= sms:
        return 1
    return n // ENCODE_TILE


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def zero_skip_encode(data: torch.Tensor):
    """Zero-skipping compaction of ``[rows, n]`` payload rows, n a power
    of two. Returns ``(vals, pos)``: the nonzero values compacted to the
    front in position order, their positions alongside (int32, -1 in the
    padding, vals 0 there). CUDA tensors launch the kernels (counted in
    ``zero_skip_encode.launches``); CPU tensors run
    :func:`repro_torch.kernels.ref.zero_skip_encode_ref`."""
    if data.dim() != 2:
        raise ValueError("zero_skip_encode takes [rows, n] data")
    rows, n = data.shape
    if n & (n - 1):
        raise ValueError(f"row length {n} must be a power of two")
    if data.device.type == "cpu":
        return zero_skip_encode_ref(data)
    build.require_cuda("zero_skip_encode", data)
    width, is_float = zero_skip_kind("zero_skip_encode", data.dtype)
    chunks = encode_chunks(rows, n, _sm_count(data.device.index))
    vals = torch.empty_like(data)
    pos = torch.empty(data.shape, dtype=torch.int32, device=data.device)
    status = torch.empty(rows * chunks + 1, dtype=torch.int64,
                         device=data.device)
    lib = build.load_library()
    with torch.cuda.device(data.device):
        rc = lib.repro_zero_skip_encode(
            data.data_ptr(), vals.data_ptr(), pos.data_ptr(),
            status.data_ptr(), rows, n, chunks, width, int(is_float),
            build.stream_of(data))
    build.check(lib, "zero_skip_encode", rc)
    zero_skip_encode.launches += 1
    return vals, pos


zero_skip_encode.launches = 0


def zero_skip_decode(vals: torch.Tensor, pos: torch.Tensor):
    """Expand zero-skip compacted ``[rows, n]`` rows (n a power of two,
    ``pos == -1`` in the padding) back into dense rows, zeros where no
    position lands. CUDA tensors launch the kernel (counted in
    ``zero_skip_decode.launches``); CPU tensors run
    :func:`repro_torch.kernels.ref.zero_skip_decode_ref`."""
    if vals.dim() != 2:
        raise ValueError("zero_skip_decode takes [rows, n] rows")
    rows, n = vals.shape
    if n & (n - 1):
        raise ValueError(f"row length {n} must be a power of two")
    if pos.shape != vals.shape:
        raise ValueError(f"vals {tuple(vals.shape)} / pos "
                         f"{tuple(pos.shape)} mismatch")
    if vals.device.type == "cpu":
        return zero_skip_decode_ref(vals, pos)
    build.require_cuda("zero_skip_decode", vals, pos)
    build.require_cuda("zero_skip_decode", pos, dtype=torch.int32)
    width, _ = zero_skip_kind("zero_skip_decode", vals.dtype)
    out = torch.empty_like(vals)
    lib = build.load_library()
    with torch.cuda.device(vals.device):
        rc = lib.repro_zero_skip_decode(
            vals.data_ptr(), pos.data_ptr(), out.data_ptr(), rows, n,
            width, build.stream_of(vals))
    build.check(lib, "zero_skip_decode", rc)
    zero_skip_decode.launches += 1
    return out


zero_skip_decode.launches = 0
