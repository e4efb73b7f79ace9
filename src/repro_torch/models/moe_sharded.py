"""Explicitly partitioned MoE dispatch (the port of the reference's
``models/moe_sharded.py``) on the emulated rank grid of ``compat``.

The reference writes the classic GShard schedule as a ``shard_map``
body:

train/prefill (tokens sharded over dp x tp via sequence parallelism):
  1. local top-k routing + local capacity-C dispatch (a local scatter)
  2. all_to_all over the EP axis ("model"): each expert's rows to its
     owner — a [tp, E_loc, C, d] exchange
  3. expert FFN on [E_loc, tp*C, d]
  4. all_to_all back + local gate-weighted combine

decode (few tokens, replicated over the model axis):
  each EP rank computes only its own experts' contributions for the
  (replicated) tokens and the combine is a psum over the model axis.

Here the ranks are the leading axes of every tensor (the plan's data
axes, then the model axis) and the collectives are ``compat``'s tensor
operations on them. The load-balance aux loss is computed per shard and
pmean'd — an approximation of the global Switch aux, as in the
reference.

Two properties of the reference are kept exactly, since they decide
which entries are dropped:

* the capacity is ``max(4, ceil4(int(n_loc k / E x capacity_factor)))``
  with ``n_loc`` the rank's tokens (truncated before rounding up; the
  dense path rounds ``ceil`` to multiples of 8, at least 8);
* in the decode form an entry routed to another rank's expert becomes
  local expert 0 with gate 0, and takes one of that expert's ``cap``
  slots: a rank's genuine entries for its first expert are dropped once
  ``cap`` foreign entries come before them in the stable order.

As in the dense path, a dropped entry is written to a spare row of the
dispatch buffer that is sliced off: nothing is written out of bounds and
no gradient flows from it (the reference's ``mode="drop"``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import compat as C
from repro_torch.compat import P
from repro_torch.models.config import ModelConfig


def _route(xt, router, k):
    """Local routing: (gates [.., n, k] f32, eids [.., n, k], probs).
    Top-k by a stable descending sort (ties to the lower expert id, as
    ``lax.top_k``)."""
    logits = xt.float() @ router.reshape(router.shape[-2:])
    probs = torch.softmax(logits, dim=-1)
    gates, eids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eids = gates[..., :k], eids[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, eids, probs


def _local_slots(eids, e: int, cap: int):
    """Each rank's dispatch plan for its entries ``eids [*ranks, n, k]``
    over ``e`` buckets of ``cap`` slots: ``(order, slot_sorted,
    slot_of_row)`` flattened to ``[G, n*k]`` (G ranks): the stable sort
    of the entries by bucket, each sorted entry's slot (``e * cap`` when
    dropped) and each entry's slot in (token, k) order."""
    n, k = eids.shape[-2:]
    flat_e = eids.reshape(-1, n * k)
    ranked, order = torch.sort(flat_e, dim=-1, stable=True)
    counts = torch.zeros((flat_e.shape[0], e), dtype=torch.int64,
                         device=eids.device).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 1) - counts
    pos = torch.arange(n * k, device=eids.device) - starts.gather(1, ranked)
    slot_sorted = torch.where(pos < cap, ranked * cap + pos, e * cap)
    slot_of_row = torch.empty_like(slot_sorted).scatter_(1, order,
                                                         slot_sorted)
    return order, slot_sorted, slot_of_row


def _local_dispatch(xt, eids, e: int, cap: int):
    """Scatter each rank's tokens into ``[*ranks, e, cap, d]`` buckets.
    ``xt [*ranks, n, d]`` may be size 1 on a rank axis where ``eids``
    is not (tokens replicated over it). Returns (disp, slot_of_row
    ``[*ranks, n*k]``: the entry's slot, or ``e * cap`` when
    dropped)."""
    lead = eids.shape[:-2]
    n, k = eids.shape[-2:]
    d = xt.shape[-1]
    order, slot_sorted, slot_of_row = _local_slots(eids, e, cap)
    g = torch.arange(order.shape[0], device=xt.device)[:, None]
    rows = xt.expand(*lead, n, d).reshape(-1, n, d)[g, order // k]
    disp = xt.new_zeros((order.shape[0], e * cap + 1, d))
    disp[g, slot_sorted] = rows
    return (disp[:, :e * cap].reshape(*lead, e, cap, d),
            slot_of_row.reshape(*lead, n * k))


def _expert_ffn(rows, wi, wg, wo, ranks: C.Ranks, tp: str):
    """The SwiGLU experts: ``rows [*ranks, e_loc, c, d]`` against each
    model rank's expert weights (``[.., e_loc, d, f]``, size 1 on the
    data axes). The data ranks' rows of one expert go through one
    product."""
    t = ranks.dims(tp)[0]
    r = rows.movedim(t, 0).movedim(ranks.n, 1)   # [tp, e_loc, *dp, c, d]
    inner = r.shape[2:-1]
    ntp, e_loc, d = r.shape[0], r.shape[1], r.shape[-1]
    r = r.reshape(ntp * e_loc, -1, d)

    def w(x):
        return x.reshape(ntp * e_loc, *x.shape[-2:])
    h = torch.bmm(r, w(wi))
    g = torch.bmm(r, w(wg))
    eo = torch.bmm(F.silu(g) * h, w(wo))
    return eo.reshape(ntp, e_loc, *inner, d).movedim(1, ranks.n).movedim(0, t)


def _combine(eo_flat, slot_of_row, gates, n: int, k: int):
    """Each entry's expert output (zeros for a dropped one) weighted by
    its gate, summed over k: ``[*ranks, n, d]``."""
    lead, d = eo_flat.shape[:-2], eo_flat.shape[-1]
    sentinel = eo_flat.shape[-2]
    eo_pad = torch.cat([eo_flat, eo_flat.new_zeros((*lead, 1, d))], dim=-2)
    idx = slot_of_row.clamp(max=sentinel)[..., None].expand(
        *slot_of_row.shape, d)
    per = eo_pad.gather(-2, idx).reshape(*lead, n, k, d)
    return (per * gates[..., None].to(per.dtype)).sum(dim=-2)


def _aux_loss(probs, eids, e: int, n: int, k: int):
    lead = probs.shape[:-2]
    me = probs.mean(dim=-2)
    ce = torch.zeros((*lead, e), dtype=torch.float32,
                     device=probs.device).scatter_add_(
        -1, eids.reshape(*lead, n * k),
        torch.full((*lead, n * k), 1.0 / (n * k), dtype=torch.float32,
                   device=probs.device))
    return e * torch.sum(me * ce, dim=-1)


class Layout(NamedTuple):
    """How ``moe_sharded`` lays one call over the plan's ranks."""
    ranks: C.Ranks
    x_spec: P
    n_loc: int       # tokens a rank routes
    cap: int         # slots a bucket
    e_loc: int       # experts a model rank owns
    x_shape: tuple   # the global [B, S, d]


def layout(x_shape, cfg: ModelConfig, plan) -> Layout:
    """The ranks (the plan's data axes, then its model axis), the
    activation spec, each rank's token count and the capacity, as the
    reference computes them. Raises ``ValueError`` where the experts,
    the batch or (sharded over the model axis) the sequence do not
    divide over the ranks: padding would change ``n_loc``, and with it
    the capacity and the drops."""
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    mesh, tp = plan.mesh, plan.tp
    dp_axes = tuple(plan.data_axes)
    ranks = C.Ranks.of(mesh, dp_axes + (tp,))
    ntp = mesh.shape[tp]
    ndp = math.prod(mesh.shape[a] for a in dp_axes)
    if e % ntp:
        raise ValueError(f"{e} experts do not divide over the {ntp} ranks "
                         f"of {tp!r}")
    b, s, _ = x_shape
    if b % ndp or (plan.shard_seq and s % ntp):
        raise ValueError(
            f"moe_sharded: batch {b} over {ndp} data ranks"
            + (f", sequence {s} over {ntp} model ranks" if plan.shard_seq
               else "") + " does not divide")
    if plan.shard_seq:
        x_spec = P(plan.dp, tp, None)
        n_loc = (b // ndp) * (s // ntp)
    else:
        x_spec = P(plan.dp, None, None)
        n_loc = (b // ndp) * s
    cap = max(4, -(-int(n_loc * k / e * m.capacity_factor) // 4) * 4)
    return Layout(ranks, x_spec, n_loc, cap, e // ntp, tuple(x_shape))


class ShardedRoute(NamedTuple):
    """Every rank's routing in one ``moe_sharded`` call: ``eids [*ranks,
    n_loc, k]`` (global expert ids; size 1 on the model axis in the
    decode form, where the tokens are replicated), ``slot [*ranks,
    n_loc, k]`` (the entry's slot in the rank's buckets, ``sentinel``
    when dropped), ``mine`` (the entry is the rank's to compute: every
    entry in the sequence-sharded form; in the decode form, those routed
    to the rank's own experts) and the layout."""
    eids: torch.Tensor
    slot: torch.Tensor
    mine: torch.Tensor
    sentinel: int
    layout: Layout

    def dropped(self) -> torch.Tensor:
        """``[*ranks, n_loc, k]``: the entries over capacity, foreign
        entries of the decode form included (gate 0)."""
        return self.slot == self.sentinel

    def dropped_kept(self) -> torch.Tensor:
        """The entries a rank should have computed and dropped."""
        return self.dropped() & self.mine

    def token_dropped(self) -> torch.Tensor:
        """``[B, S]`` bool: the tokens that lost an entry on some rank."""
        b, s, _ = self.layout.x_shape
        lost = self.dropped_kept().any(-1)                 # [*ranks, n]
        ids = C.to_ranks(torch.arange(b * s, device=lost.device).reshape(
            b, s, 1), self.layout.ranks, self.layout.x_spec)
        ids = ids.reshape(*ids.shape[:-3], -1).expand(lost.shape)
        return torch.zeros(b * s, dtype=torch.int64,
                           device=lost.device).index_add_(
            0, ids.reshape(-1), lost.reshape(-1).long()).reshape(b, s) > 0


def sharded_route(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  plan) -> ShardedRoute:
    """The routing of :func:`moe_sharded` alone (no dispatch, no
    experts), for checks of the drops."""
    lay = layout(x.shape, cfg, plan)
    m, ranks, tp = cfg.moe, lay.ranks, plan.tp
    xr = C.to_ranks(x, ranks, lay.x_spec)
    lead = xr.shape[:ranks.n]
    xt = xr.reshape(*lead, -1, x.shape[-1])
    n, k = xt.shape[-2], m.top_k
    _, eids, _ = _route(xt, p["router"], k)
    if plan.shard_seq:
        mine = torch.ones_like(eids, dtype=torch.bool)
        buckets, routed = m.num_experts, eids
    else:
        local = eids - C.axis_index(ranks, tp, x.device, 2) * lay.e_loc
        mine = (local >= 0) & (local < lay.e_loc)
        buckets, routed = lay.e_loc, torch.where(mine, local, 0)
    _, _, slot = _local_slots(routed, buckets, lay.cap)
    return ShardedRoute(eids, slot.reshape(*routed.shape[:-2], n, k), mine,
                        buckets * lay.cap, lay)


def moe_sharded(p: dict, x: torch.Tensor, cfg: ModelConfig, plan):
    """The MoE of a mesh'd plan on the emulated ranks. Returns ``(out
    [B, S, d], aux)``."""
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    tp = plan.tp
    dp_axes = tuple(plan.data_axes)
    all_axes = dp_axes + (tp,)
    lay = layout(x.shape, cfg, plan)
    ntp, e_loc, cap = plan.mesh.shape[tp], lay.e_loc, lay.cap
    d = x.shape[-1]
    w_spec = P(tp, None, None)     # dp (FSDP) shards gathered at entry
    r_spec = P(None, None)

    if plan.shard_seq:
        def fn(R, xl, router, wi, wg, wo):
            lead = xl.shape[:R.n]
            bl, sl = xl.shape[R.n:R.n + 2]
            n = bl * sl
            xt = xl.reshape(*lead, n, d)
            gates, eids, probs = _route(xt, router, k)
            disp, slot_of_row = _local_dispatch(xt, eids, e, cap)
            # EP exchange: [tp_dest, e_loc, cap, d] -> rows at owners (each
            # buffer is let go once the next exists: they are the layer's
            # largest)
            rx = C.all_to_all(disp.reshape(*lead, ntp, e_loc, cap, d), R, tp,
                              0, 0, tiled=True)               # [tp_src, ..]
            del disp
            rows = rx.transpose(-4, -3).reshape(*lead, e_loc, ntp * cap, d)
            del rx
            eo = _expert_ffn(rows, wi, wg, wo, R, tp)
            del rows
            tx = C.all_to_all(eo.reshape(*lead, e_loc, ntp, cap, d)
                              .transpose(-4, -3), R, tp, 0, 0,
                              tiled=True)                     # [tp_dest->me]
            del eo
            y = _combine(tx.reshape(*lead, e * cap, d), slot_of_row, gates,
                         n, k)
            aux = C.pmean(_aux_loss(probs, eids, e, n, k), R, all_axes)
            return y.reshape(*lead, bl, sl, d), aux
    else:
        def fn(R, xl, router, wi, wg, wo):
            lead = xl.shape[:R.n]
            bl, sl = xl.shape[R.n:R.n + 2]
            n = bl * sl
            xt = xl.reshape(*lead, n, d)
            gates, eids, probs = _route(xt, router, k)
            my_tp = C.axis_index(R, tp, x.device, local_ndim=2)
            local_eids = eids - my_tp * e_loc
            mine = (local_eids >= 0) & (local_eids < e_loc)
            masked_gates = torch.where(mine, gates, 0.0)
            safe_eids = torch.where(mine, local_eids, 0)
            disp, slot_of_row = _local_dispatch(xt, safe_eids, e_loc, cap)
            eo = _expert_ffn(disp, wi, wg, wo, R, tp)
            del disp
            y = _combine(eo.reshape(*eo.shape[:R.n], e_loc * cap, d),
                         slot_of_row, masked_gates, n, k)
            y = C.psum(y, R, tp)
            aux = _aux_loss(probs, eids, e, n, k)
            if dp_axes:
                aux = C.pmean(aux, R, dp_axes)
            return y.reshape(*y.shape[:R.n], bl, sl, d), aux

    return C.shard_map(
        fn, plan.mesh, in_specs=(lay.x_spec, r_spec, w_spec, w_spec, w_spec),
        out_specs=(lay.x_spec, P()), axes=all_axes,
    )(x, p["router"], p["wi"], p["wg"], p["wo"])
