"""The paper's BTIO request pattern in the write executor's units.

``repro.io_patterns.generators.btio_pattern`` builds BTIO in byte units
for the host executor; this builds the same block-tridiagonal partition
in 4-byte elements as the ``(O, L, C, D)`` numpy arrays the rank-axis
executor takes (``repro_torch.core.requests.requests_from_numpy``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.requests import PAD_OFFSET


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
