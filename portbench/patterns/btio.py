"""NAS BT-IO's checkpoint write pattern, in elements of the solution's
type.

BT-IO (NPB 3 I/O, full MPI-IO) writes the solution ``u(5, N, N, N)``
of BT, five double-precision words a grid point in Fortran order, as
BT's diagonal multi-partition lays it out: the ranks form a ``q x q``
grid (``q = sqrt(P)``), each rank owns ``q`` cells, and cell ``c`` of
rank ``(row, col)`` is cell ``((col + c) mod q, (row - c) mod q, c)``
of the ``q x q x q`` cells (NPB's ``make_set``). Along each axis the
first ``N mod q`` cells hold ``N // q + 1`` points and the others
``N // q``. A rank's file view is its cells in cell order, each a
subarray, so its requests are one run of ``5 * (cell's x points)``
words for each ``(y, z)`` line of each cell, in offset order.

The payload is not drawn here: the harness draws it on the device from
the run's seed, so that this module gives the geometry alone.
"""
from __future__ import annotations

import numpy as np

PAD_OFFSET = 2**31 - 1          # padding offset of a request list (int32 max)


def cell_extents(n: int, q: int):
    """``(low, size)`` of each of the ``q`` cells along an axis of ``n``
    points, as NPB's ``make_set`` splits it."""
    size, excess = divmod(n, q)
    k = np.arange(q, dtype=np.int64)
    low = np.where(k < excess, k * (size + 1),
                   excess * (size + 1) + (k - excess) * size)
    return low, np.where(k < excess, size + 1, size)


def btio_pattern(n_ranks: int, grid: int, n_vars: int = 5):
    """Every rank's requests of one BT-IO dump of a ``grid``-cubed
    solution of ``n_vars`` words a point.

    Returns ``O, L [P, req_cap]`` (int32; ``PAD_OFFSET``/0 past each
    count), ``C [P]``, the largest rank's payload length and the file
    length, all in words.
    """
    q = int(round(np.sqrt(n_ranks)))
    if q * q != n_ranks or grid < q:
        raise ValueError("BT-IO needs a square rank count of at most "
                         "grid**2")
    if n_vars * grid**3 > PAD_OFFSET:
        raise ValueError("file exceeds the int32 element range")
    low, size = cell_extents(grid, q)
    p = np.arange(n_ranks, dtype=np.int64)
    row, col = p // q, p % q
    smax = int(size.max())
    yy = np.arange(smax, dtype=np.int64)
    offs, lens, live = [], [], []
    for c in range(q):                 # cell order = z-block order
        xb, yb = (col + c) % q, (row - c) % q
        # [P, z, y]: one request a (y, z) line of the cell
        z = low[c] + np.arange(size[c], dtype=np.int64)
        y = low[yb][:, None] + yy[None, :]
        o = n_vars * (low[xb][:, None, None]
                      + grid * (y[:, None, :] + grid * z[None, :, None]))
        ok = np.broadcast_to((yy[None, :] < size[yb][:, None])[:, None, :],
                             o.shape)
        offs.append(o.reshape(n_ranks, -1))
        lens.append(np.broadcast_to((n_vars * size[xb])[:, None, None],
                                    o.shape).reshape(n_ranks, -1))
        live.append(ok.reshape(n_ranks, -1))
    offs, lens, live = (np.concatenate(x, axis=1) for x in (offs, lens, live))
    # the live requests to the front of each row, in order
    order = np.argsort(~live, axis=1, kind="stable")
    C = live.sum(axis=1)
    req_cap = int(C.max())
    order = order[:, :req_cap]
    keep = np.arange(req_cap)[None, :] < C[:, None]
    O = np.where(keep, np.take_along_axis(offs, order, 1), PAD_OFFSET)
    L = np.where(keep, np.take_along_axis(lens, order, 1), 0)
    data_cap = int(L.sum(axis=1).max())
    return (O.astype(np.int32), L.astype(np.int32), C.astype(np.int32),
            data_cap, n_vars * grid**3)


def geometry(cfg: dict):
    """``(O, L, C, data_cap, file_len)`` of the configuration."""
    return btio_pattern(cfg["nodes"] * cfg["ranks_per_node"], cfg["grid"],
                        cfg["n_vars"])
