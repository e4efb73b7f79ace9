"""The file image a collective write must leave and the payloads a
collective read must return, worked out request by request.

Each rank's payload row holds its requests' elements back to back, in
request order: element ``e`` of rank ``p`` belongs to the request whose
running end first passes ``e`` and lands at that request's offset plus
``e``'s distance from the request's start. The functions run on the
tensors' own device, a block of ranks at a time, so that their int64
positions stay small beside the file.
"""
from __future__ import annotations

import torch

BLOCK_RANKS = 64


def _positions(O, L, C, data_cap: int):
    """File positions ``[b, data_cap]`` (int64) of a block of ranks'
    payload elements, and which of them are live."""
    cap = O.shape[1]
    n = torch.arange(cap, device=O.device)
    lengths = torch.where(n < C.to(torch.int64)[:, None],
                          L.to(torch.int64), 0)
    ends = lengths.cumsum(dim=1)
    e = torch.arange(data_cap, device=O.device).expand(O.shape[0], data_cap)
    req = torch.searchsorted(ends, e.contiguous(), right=True).clamp_(
        max=cap - 1)
    pos = O.to(torch.int64).gather(1, req) + e - (ends - lengths).gather(
        1, req)
    return pos, e < ends[:, -1:]


def scatter_file(O, L, C, D, file_len: int) -> torch.Tensor:
    """The file ``[file_len]`` that writing every rank's first ``C[p]``
    requests leaves, zeros where no request lands. Raises
    ``ValueError`` when two requests overlap or one leaves the file: the
    configurations state disjoint requests inside the file."""
    file = torch.zeros(file_len, dtype=D.dtype, device=D.device)
    covered = torch.zeros(file_len, dtype=torch.bool, device=D.device)
    live_total = 0
    for p0 in range(0, O.shape[0], BLOCK_RANKS):
        rows = slice(p0, p0 + BLOCK_RANKS)
        pos, live = _positions(O[rows], L[rows], C[rows], D.shape[1])
        pos = pos[live]
        if pos.numel() and (int(pos.min()) < 0 or int(pos.max()) >= file_len):
            raise ValueError("a request leaves the file")
        file[pos] = D[rows][live]
        covered[pos] = True
        live_total += pos.numel()
    if int(covered.sum()) != live_total:
        raise ValueError("requests overlap")
    return file


def gather_payloads(O, L, C, file, data_cap: int) -> torch.Tensor:
    """Every rank's payload ``[P, data_cap]`` read back from ``file``:
    its first ``C[p]`` requests' elements in order, zeros past them."""
    out = torch.zeros((O.shape[0], data_cap), dtype=file.dtype,
                      device=file.device)
    for p0 in range(0, O.shape[0], BLOCK_RANKS):
        rows = slice(p0, p0 + BLOCK_RANKS)
        pos, live = _positions(O[rows], L[rows], C[rows], data_cap)
        block = out[rows]
        block[live] = file[pos[live]]
    return out


_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def mismatches(got, want) -> int:
    """Elements of ``got`` whose bits differ from ``want``'s; every
    element when the shapes or types differ."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return want.numel()
    if want.dtype.is_floating_point:
        bits = _BITS[want.element_size()]
        got, want = got.view(bits), want.view(bits)
    return int((got != want).sum())


def control_write(O, L, C, D, file_len: int) -> torch.Tensor:
    """The control: the reference in the program's place with one
    guarantee broken, every rank's last request left out of the file."""
    return scatter_file(O, L, (C - 1).clamp(min=0), D, file_len)


def control_read(O, L, C, file, data_cap: int) -> torch.Tensor:
    """The control of a read: every rank's last request not read back."""
    return gather_payloads(O, L, (C - 1).clamp(min=0), file, data_cap)
