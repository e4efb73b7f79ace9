"""The cost counters' registry, below the kernels and the collectives.

``launch.op_analysis.OpCounter`` registers itself here while it is on.
The attention's wrappers (``kernels.ops.fused_attention``,
``kernels.flash.FlashAttention.backward``) and ``compat``'s collectives
report to it through :func:`count_attention` and
:func:`count_collective`, and run their implementation under
:func:`uncounted`. With no counter on, each of these returns at once:
no list is built and no context is entered.
"""
from __future__ import annotations

import contextlib
import math

import torch

_ACTIVE: list = []   # the counters that are on, innermost last


def _add(d: dict, key, value) -> None:
    d[key] = d.get(key, 0) + value


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _ring_bytes(kind: str, size: int, n: int) -> float:
    """Wire bytes per device of one collective whose per-device result
    is ``size`` bytes over a group of ``n`` (the reference's
    ``hlo_analysis._ring_bytes``)."""
    if n <= 1:
        return 0.0
    f = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * size * f
    if kind == "collective-permute":
        return float(size)
    return size * f          # all-gather / reduce-scatter / all-to-all


def attention_work(b: int, sq: int, hq: int, skv: int, causal: bool,
                   window: int | None, q_offset: int,
                   kv_len: int | None) -> tuple[int, int]:
    """``(pairs, keys)`` of one attention call: the (query, key) pairs
    its masks leave, summed over the batch and the query heads, and the
    number of keys some query sees (the keys it must read). Query ``i``
    sits at position ``s = q_offset + i`` and sees keys ``[lo(s),
    hi(s))``: ``hi = min(kv_len, s + 1)`` (causal) or ``kv_len``, ``lo =
    max(0, s - window + 1)`` (windowed) or 0, ``kv_len`` at most
    ``skv``. Both ends are linear in s between the breaks at ``kv_len``
    and ``window``, so each piece sums in closed form."""
    kvl = skv if kv_len is None else min(skv, kv_len)
    s0, s1 = q_offset, q_offset + sq
    cuts = {s0, s1}
    for c in (kvl if causal else None, window):
        if c is not None and s0 < c < s1:
            cuts.add(c)
    cuts = sorted(cuts)
    pairs, first, last = 0, None, None
    for a, e in zip(cuts, cuts[1:]):
        up = causal and a < kvl                 # hi = s + 1 on [a, e)
        slid = window is not None and a >= window   # lo = s - window + 1
        slope = int(up) - int(slid)
        icpt = (1 if up else kvl) - ((1 - window) if slid else 0)
        lo_s, hi_s = a, e                       # where slope*s + icpt > 0
        if slope > 0:
            lo_s = max(a, 1 - icpt)
        elif slope < 0:
            hi_s = min(e, icpt)
        elif icpt <= 0:
            hi_s = a
        if lo_s >= hi_s:
            continue
        n = hi_s - lo_s
        pairs += n * (2 * icpt + slope * (lo_s + hi_s - 1)) // 2
        first = lo_s if first is None else first
        last = hi_s - 1

    def hi(s):
        return min(kvl, s + 1) if causal else kvl

    def lo(s):
        return max(0, s - window + 1) if window is not None else 0
    keys = 0 if first is None else hi(last) - lo(first)
    return b * hq * pairs, keys


@contextlib.contextmanager
def _paused(counters):
    for c in counters:
        c.paused += 1
    try:
        yield
    finally:
        for c in counters:
            c.paused -= 1


def uncounted():
    """Pause every active counter: the ops inside add nothing (the
    attention's implementation, after :func:`count_attention`). Without
    a counter, ``contextlib.nullcontext()``."""
    if not _ACTIVE:
        return contextlib.nullcontext()
    return _paused(list(_ACTIVE))


def _counting() -> list:
    return [c for c in _ACTIVE if not c.paused]


def count_attention(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
                    window: int | None, q_offset: int,
                    kv_len: int | None, backward: bool = False) -> None:
    """Add one attention call (``backward``: its gradient) to every
    active counter, by formula from the shapes and masks (the forward
    4·hd·pairs, the backward 8·hd·pairs; the bytes of q, the output and
    the keys and values some query sees, twice over for the backward's
    gradients)."""
    if not _ACTIVE:
        return
    counters = _counting()
    if not counters:
        return
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    pairs, keys = attention_work(b, sq, hq, skv, causal, window, q_offset,
                                 kv_len)
    per = 4 if backward else 2          # q-shaped / k-shaped tensors moved
    flops = (8 if backward else 4) * hd * pairs
    nbytes = per * (b * sq * hq * hd + b * keys * hkv * hd) \
        * q.element_size()
    for c in counters:
        c.cost.flops += flops
        c.cost.attention_flops += flops
        _add(c.cost.flops_by_dtype, _dtype_name(q.dtype), flops)
        c.cost.bytes += nbytes
        c.cost.devices.add(q.device.type)


def count_collective(kind: str, result: torch.Tensor, n_rank_axes: int,
                     group: int) -> None:
    """Add one collective to every active counter: ``result`` is the
    emulated result (``n_rank_axes`` leading rank axes, then one rank's
    tensor), ``group`` the number of ranks it spans."""
    if not _ACTIVE:
        return
    counters = _counting()
    if not counters:
        return
    local = tuple(result.shape[n_rank_axes:])
    size = math.prod(local) * result.element_size()
    wire = _ring_bytes(kind, size, group)
    for c in counters:
        _add(c.cost.coll_bytes, kind, wire)
        _add(c.cost.coll_count, kind, 1)
        c.cost.coll_detail.append((kind, local, group, wire))
