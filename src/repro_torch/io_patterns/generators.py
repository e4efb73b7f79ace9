"""The paper's I/O request patterns (Table I), as executor inputs.

Two forms. The five byte-unit generators are the reference's
``repro.io_patterns.generators`` with the same names, signatures and
seeds: each returns per-rank ``(offsets int64, lengths int64, payload
uint8)`` numpy triples, the input of
``repro_torch.checkpoint.HostCollectiveIO``. The structures match the
paper:

* E3SM F/G: every rank holds a long list of SMALL noncontiguous
  requests interleaved round-robin across ranks (cubed-sphere / MPAS
  decompositions) — little coalescing, communication-bound.
* BTIO: block-tridiagonal partition — adjacent ranks own adjacent slabs
  per row, so intra-node aggregation coalesces heavily.
* S3D-IO: block-block-block partition, 4 variables — same coalescing
  structure, fewer requests.
* sparse checkpoint pages: fixed-size pages, most of them all zero —
  the workload of the slow-hop zero-run codec.

:func:`rank_requests_to_elements` turns such a list into the ``(O, L,
C, D)`` arrays of the rank-axis executor
(``repro_torch.core.requests.requests_from_numpy``) in elements of a
given type, and :func:`btio_write_pattern` builds BTIO directly in
4-byte elements at deployment size. They are host data: numpy, as in
the reference.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.requests import PAD_OFFSET


def _payload(total: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed)
            .integers(1, 255, size=total, dtype=np.uint8))


def e3sm_g_pattern(n_ranks: int, reqs_per_rank: int = 64,
                   req_bytes: int = 64, seed: int = 0):
    """Interleaved small requests: rank r owns slots r, r+P, r+2P, ..."""
    out = []
    for r in range(n_ranks):
        idx = np.arange(reqs_per_rank, dtype=np.int64)
        offs = (idx * n_ranks + r) * req_bytes
        lens = np.full(reqs_per_rank, req_bytes, np.int64)
        out.append((offs, lens, _payload(int(lens.sum()), seed + r)))
    return out


def e3sm_f_pattern(n_ranks: int, reqs_per_rank: int = 256,
                   req_bytes: int = 16, seed: int = 1):
    """F case: ~8x more, ~4x smaller requests than G (14 GiB over 1.4e9)."""
    return e3sm_g_pattern(n_ranks, reqs_per_rank, req_bytes, seed)


def btio_pattern(n_ranks: int, n: int = 64, vars_: int = 4, seed: int = 2):
    """Block-tridiagonal: sqrt(P) x sqrt(P) partition of [N, N] rows of
    length N (the unpartitioned last dims collapse into the row unit).
    Adjacent ranks own adjacent row-blocks -> coalescible at the node.
    """
    side = int(round(np.sqrt(n_ranks)))
    assert side * side == n_ranks, "BTIO needs a square rank count"
    cell = 8  # bytes per element-row unit
    rows_per = n // side
    out = []
    for r in range(n_ranks):
        ri, ci = divmod(r, side)
        offs, lens = [], []
        for v in range(vars_):
            base = v * n * n * cell
            for row in range(ri * rows_per, (ri + 1) * rows_per):
                offs.append(base + (row * n + ci * rows_per) * cell)
                lens.append(rows_per * cell)
        offs = np.asarray(offs, np.int64)
        lens = np.asarray(lens, np.int64)
        order = np.argsort(offs, kind="stable")
        out.append((offs[order], lens[order],
                    _payload(int(lens.sum()), seed + r)))
    return out


def sparse_checkpoint_pattern(n_ranks: int, pages_per_rank: int = 8,
                              page_bytes: int = 2048,
                              zero_page_fraction: float = 0.75,
                              seed: int = 7):
    """Sparse checkpoint pages: each rank owns a contiguous run of
    fixed-size pages of which ``zero_page_fraction`` are ENTIRELY zero
    (pruned weights, zero-initialized optimizer slots, padding) — the
    workload the slow-hop zero-run codec exists for. The zero pages are
    page-aligned runs far longer than ``codec.RLE_MIN_RUN``, so the
    achieved wire ratio tracks ``1 / (1 - zero_page_fraction)`` and the
    modeled-vs-measured agreement is CI-gated
    (``benchmarks/check_regression.py``)."""
    rng0 = np.random.default_rng(seed)
    out = []
    for r in range(n_ranks):
        offs = ((np.arange(pages_per_rank, dtype=np.int64)
                 + r * pages_per_rank) * page_bytes)
        lens = np.full(pages_per_rank, page_bytes, np.int64)
        pages = np.zeros((pages_per_rank, page_bytes), np.uint8)
        live = rng0.random(pages_per_rank) >= zero_page_fraction
        n_live = int(live.sum())
        if n_live:
            pages[live] = rng0.integers(
                1, 255, size=(n_live, page_bytes), dtype=np.uint8)
        out.append((offs, lens, pages.reshape(-1)))
    return out


def s3d_pattern(n_ranks: int, n: int = 32, seed: int = 3):
    """Block-block-block 3D partition; 4 checkpoint variables."""
    side = int(round(n_ranks ** (1 / 3)))
    while side ** 3 > n_ranks:
        side -= 1
    p3 = side ** 3
    cell = 8
    bpr = n // side
    out = []
    var_sizes = [1, 1, 3, 11]
    for r in range(n_ranks):
        if r >= p3:
            out.append((np.zeros(0, np.int64), np.zeros(0, np.int64),
                        np.zeros(0, np.uint8)))
            continue
        zi, rem = divmod(r, side * side)
        yi, xi = divmod(rem, side)
        offs, lens = [], []
        base = 0
        for vs in var_sizes:
            for w in range(vs):
                vbase = base + w * n * n * n * cell
                for z in range(zi * bpr, (zi + 1) * bpr):
                    for y in range(yi * bpr, (yi + 1) * bpr):
                        offs.append(vbase + ((z * n + y) * n + xi * bpr)
                                    * cell)
                        lens.append(bpr * cell)
            base += vs * n * n * n * cell
        offs = np.asarray(offs, np.int64)
        lens = np.asarray(lens, np.int64)
        order = np.argsort(offs, kind="stable")
        out.append((offs[order], lens[order],
                    _payload(int(lens.sum()), seed + r)))
    return out


def rank_requests_to_elements(rank_requests, elem_dtype):
    """Per-rank byte-unit ``(offsets, lengths, payload)`` triples as the
    ``(O, L, C, D)`` arrays of ``requests_from_numpy``, in elements of
    ``elem_dtype``.

    ``O``/``L`` are int32 ``[P, req_cap]`` (``PAD_OFFSET``/0 past each
    count), ``C`` the int32 counts ``[P]`` and ``D`` the payload bytes
    viewed as ``elem_dtype``, ``[P, data_cap]`` (zeros past each
    rank's bytes); ``req_cap`` and ``data_cap`` are the largest rank's
    (at least 1). Raises ``ValueError`` when an offset or length is not a
    whole number of elements, or a request ends past the int32 element
    range (``PAD_OFFSET`` is the padding's).
    """
    dt = np.dtype(elem_dtype)
    eb = dt.itemsize
    P = len(rank_requests)
    counts = [int(np.asarray(o).size) for o, _, _ in rank_requests]
    req_cap = max(counts + [1])
    data_cap = max([int(np.asarray(ln, np.int64).sum()) // eb
                    for _, ln, _ in rank_requests] + [1])
    O = np.full((P, req_cap), PAD_OFFSET, np.int32)
    L = np.zeros((P, req_cap), np.int32)
    D = np.zeros((P, data_cap), dt)
    for p, (offs, lens, data) in enumerate(rank_requests):
        offs = np.asarray(offs, np.int64)
        lens = np.asarray(lens, np.int64)
        if ((offs % eb) != 0).any() or ((lens % eb) != 0).any():
            raise ValueError(f"rank {p}: a request is not a whole number "
                             f"of {eb}-byte elements")
        if offs.size and int(((offs + lens) // eb).max()) > PAD_OFFSET:
            raise ValueError(f"rank {p}: the file exceeds the int32 "
                             "element range")
        if offs.size and int(offs.min()) < 0:
            raise ValueError(f"rank {p}: negative offset")
        n = int(lens.sum()) // eb
        O[p, :offs.size] = offs // eb
        L[p, :offs.size] = lens // eb
        D[p, :n] = np.ascontiguousarray(
            np.asarray(data, np.uint8)[:n * eb]).view(dt)
    return O, L, np.asarray(counts, np.int32), D

def btio_write_pattern(n_ranks: int, n_cells: int, n_vars: int = 4,
                       cell_elems: int = 8, seed: int = 0):
    """Block-tridiagonal partition of ``n_vars`` variables, each an
    ``n_cells x n_cells`` array of cells of ``cell_elems`` elements,
    stored variable-major then row-major.

    The ranks form a ``side x side`` grid (``side = sqrt(n_ranks)``);
    rank ``r = (ri, ci)`` owns rows ``ri * b .. (ri+1) * b - 1`` and
    cells ``ci * b .. (ci+1) * b - 1`` of every variable, with
    ``b = n_cells / side``: one request of ``b * cell_elems`` elements
    per owned row and variable, in offset order. Adjacent ranks own
    adjacent pieces of a row, so a node's requests coalesce into whole
    rows. The payload is int32 words drawn from
    ``numpy.random.default_rng(seed)``.

    Returns ``O, L [P, n_vars * b]`` (int32), ``C [P]`` and
    ``D [P, n_vars * b * b * cell_elems]``; the file is
    ``n_vars * n_cells**2 * cell_elems`` elements.
    """
    side = int(round(np.sqrt(n_ranks)))
    if side * side != n_ranks or n_cells % side:
        raise ValueError("BTIO needs a square rank count dividing n_cells")
    b = n_cells // side
    var_len = n_cells * n_cells * cell_elems
    if n_vars * var_len > PAD_OFFSET:
        raise ValueError("file exceeds the int32 element range")
    r = np.arange(n_ranks, dtype=np.int64)
    ri, ci = r // side, r % side
    v = np.arange(n_vars, dtype=np.int64)[:, None]
    row = np.arange(b, dtype=np.int64)[None, :]
    # [P, n_vars, b]: variable-major, then row: already offset-sorted
    offs = (v[None] * var_len
            + ((ri[:, None, None] * b + row[None]) * n_cells
               + ci[:, None, None] * b) * cell_elems)
    O = offs.reshape(n_ranks, n_vars * b).astype(np.int32)
    L = np.full_like(O, b * cell_elems)
    C = np.full((n_ranks,), n_vars * b, np.int32)
    rng = np.random.default_rng(seed)
    D = rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max,
                     size=(n_ranks, n_vars * b * b * cell_elems),
                     dtype=np.int32, endpoint=True)
    return O, L, C, D
