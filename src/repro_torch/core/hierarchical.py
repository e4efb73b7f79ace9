"""Two-layer (TAM-style) collectives for training-time communication
(the port of the reference's ``core/hierarchical.py``).

The paper's congestion argument — aggregate inside the fast domain
first so the slow domain sees fewer endpoints and less metadata —
applied to gradient synchronization and MoE dispatch on a multi-pod
mesh:

* ``two_layer_psum``    — reduce-scatter over the fast axis, all-reduce
  over the slow axis on the 1/q-size shard only, all-gather back over
  the fast axis. Slow-axis bytes drop from |g| to |g|/q per rank.
* ``compressed_psum``   — the same schedule with the registry's
  error-feedback int8 codec (``ef-int8``) applied ONLY to the slow hop.
* ``two_layer_all_to_all`` — hierarchical MoE dispatch: chunks are
  exchanged within the pod first, grouped per destination pod, then one
  aggregated inter-pod exchange.

The reference runs these inside ``shard_map`` bodies over axis names;
here every rank is a slice of a leading rank axis (``compat``): ``x`` is
``[*ranks, *local]`` with ``ranks`` naming the leading axes, and the
results come back in the same form (an axis reduced over has size 1:
the value every rank of it holds).
"""
from __future__ import annotations

import torch

from repro_torch import compat as C
from repro_torch._tree import leaves, unflatten
from repro_torch.compat import Ranks
from repro_torch.core import codec as codec_mod


def _flat_padded(x: torch.Tensor, ranks: Ranks, mult: int):
    """Each rank's tensor flattened and zero-padded to a multiple of
    ``mult``: ``([*ranks, L], n)`` with ``n`` the unpadded length (the
    reference's ``_pad_to``)."""
    flat = x.reshape(*x.shape[:ranks.n], -1)
    n = flat.shape[-1]
    pad = (-n) % mult
    if pad:
        flat = torch.cat([flat, flat.new_zeros((*flat.shape[:-1], pad))],
                         dim=-1)
    return flat, n


def _unflat(full: torch.Tensor, ranks: Ranks, n: int, shape) -> torch.Tensor:
    return full[..., :n].reshape(*full.shape[:ranks.n], *shape)


def two_layer_psum(x: torch.Tensor, ranks: Ranks, fast_axis: str,
                   slow_axis: str) -> torch.Tensor:
    """psum(x) over (fast, slow) with the TAM schedule: the sum equals
    ``psum(x, (fast, slow))`` up to f32 reassociation; the slow-axis
    transfer is the scattered 1/q shard."""
    shape = x.shape[ranks.n:]
    q = C.axis_size(ranks, fast_axis)
    flat, n = _flat_padded(x, ranks, q)
    shard = C.psum_scatter(flat, ranks, fast_axis, 0, tiled=True)  # intra: RS
    shard = C.psum(shard, ranks, slow_axis)                # inter: AR (1/q)
    full = C.all_gather(shard, ranks, fast_axis, 0, tiled=True)  # intra: AG
    return _unflat(full, ranks, n, shape)


# The int8 arithmetic lives in the shared slow-hop codec subsystem
# (``core.codec``, the "ef-int8" registry entry); the reference keeps
# these private names as aliases for callers that reached in.
def _int8_encode(x: torch.Tensor):
    return codec_mod.int8_encode(x)


def _int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codec_mod.int8_decode(q, scale)


def compressed_psum(x: torch.Tensor, residual: torch.Tensor, ranks: Ranks,
                    fast_axis: str, slow_axis: str):
    """Two-layer psum with error-feedback int8 on the slow hop only.

    The fast-axis reduce-scatter runs at full precision; each rank adds
    its residual's shard (at ``axis_index(fast) * shard_len``) and
    quantizes the sum with one scale for the shard; the slow-axis sum
    moves the int8 codes, decoded. Returns ``(psum_result,
    new_residual)``: the result on every rank (size 1 on both axes; a
    NaN or inf in a rank's shard reaches it, as the reference's
    ``shard * 0 + reduced`` does) and the new residual gathered over the
    fast axis only, per slow rank. Each intermediate is let go once
    used: a rank's leaf may be gigabytes, and every rank is on one
    device."""
    ef = codec_mod.get_codec("ef-int8")
    shape = x.shape[ranks.n:]
    q = C.axis_size(ranks, fast_axis)
    flat, n = _flat_padded(x, ranks, q)
    shard = C.psum_scatter(flat, ranks, fast_axis, 0, tiled=True)
    del flat
    res_flat, _ = _flat_padded(residual, ranks, q)
    at = C.axis_index(ranks, fast_axis, x.device, local_ndim=2)
    res_shard = torch.take_along_dim(
        res_flat.unflatten(-1, (q, -1)), at, dim=-2).squeeze(-2)
    del res_flat
    wire, new_res_shard = ef.tensor_encode(shard, res_shard)
    del res_shard
    reduced = C.psum(ef.tensor_decode(wire), ranks, slow_axis)
    del wire
    reduced = shard.mul(0).add_(reduced)        # shard * 0 + reduced
    del shard
    full = C.all_gather(reduced, ranks, fast_axis, 0, tiled=True)
    del reduced
    new_res = C.all_gather(new_res_shard, ranks, fast_axis, 0, tiled=True)
    return (_unflat(full, ranks, n, shape),
            _unflat(new_res, ranks, n, residual.shape[ranks.n:]))


def two_layer_all_to_all(x: torch.Tensor, ranks: Ranks, fast_axis: str,
                         slow_axis: str) -> torch.Tensor:
    """Hierarchical all-to-all over the flattened (slow, fast) rank
    space.

    x: ``[*ranks, n_slow * n_fast, ...]`` — chunk d goes to global rank
    d. An intra-pod exchange that groups chunks by destination pod, then
    one inter-pod exchange of pod-aggregated slabs: the permutation of a
    flat all_to_all over both axes, with every slow-axis message a
    q-chunk aggregate."""
    ns = C.axis_size(ranks, slow_axis)
    nf = C.axis_size(ranks, fast_axis)
    lead = x.shape[:ranks.n]
    if x.shape[ranks.n] != ns * nf:
        raise ValueError(f"leading local dim {x.shape[ranks.n]} must be "
                         f"n_slow * n_fast = {ns * nf}")
    tail = x.shape[ranks.n + 1:]
    # group by (dest pod, dest fast slot): grouped[t, u] -> rank (t, u)
    grouped = x.reshape(*lead, ns, nf, *tail)
    # intra-pod: rank (s, f) gets intra[u', t] = the chunk from fast
    # peer u' destined to (pod t, slot f)
    intra = C.all_to_all(grouped, ranks, fast_axis, 1, 0, tiled=False)
    # inter-pod: inter[s', u'] = the chunk from global rank (s', u')
    inter = C.all_to_all(intra, ranks, slow_axis, 1, 0, tiled=False)
    return inter.reshape(*inter.shape[:ranks.n], ns * nf, *tail)


def tree_two_layer_psum(tree, ranks: Ranks, fast_axis: str, slow_axis: str):
    return unflatten(tree, [two_layer_psum(g, ranks, fast_axis, slow_axis)
                            for g in leaves(tree)])


def tree_compressed_psum(tree, residuals, ranks: Ranks, fast_axis: str,
                         slow_axis: str):
    out, new_res = [], []
    for g, r in zip(leaves(tree), leaves(residuals)):
        o, nr = compressed_psum(g, r, ranks, fast_axis, slow_axis)
        out.append(o)
        new_res.append(nr)
    return unflatten(tree, out), unflatten(residuals, new_res)
