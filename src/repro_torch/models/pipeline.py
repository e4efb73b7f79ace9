"""GPipe-style pipeline parallelism as a composable transform (the port
of the reference's ``models/pipeline.py``), on the emulated rank grid of
``compat``.

An optional "pipe" axis: the layer stack is split into S stages;
microbatches stream through the stages with ``ppermute`` handoffs. S +
M - 1 rounds for M microbatches (the GPipe bubble is (S-1)/(S+M-1)).

Independent of the model's main path: a per-stage apply function is
wrapped, and the weights arrive stage-sharded (a leading dim of S).
"""
from __future__ import annotations

import torch

from repro_torch import compat as C
from repro_torch._tree import leaves, unflatten
from repro_torch.compat import P


def pipeline_apply(stage_fn, mesh, *, axis: str = "pipe",
                   microbatches: int):
    """Build ``fn(stage_params, x) -> y`` running the S-stage pipeline.

    ``stage_fn(params_slice, x_mb)`` applies ONE stage to ONE
    microbatch. ``stage_params``: a tree whose leaves have a leading dim
    S. ``x``: ``[M * mb, ...]``, the global batch, split over the stages
    on dim 0 for transport (as the reference's in_specs), then gathered.
    Each round, every stage s runs ``stage_fn`` once on its parameter
    slice: stage 0 on microbatch t of the gathered batch, the others on
    the activations handed over by ``ppermute``; a stage whose
    microbatch ``t - s`` is not in ``[0, M)`` keeps its activations. The
    last stage emits microbatch ``t - (S - 1)``, a ``psum`` over the
    stages broadcasts the outputs, and each stage keeps its slice.
    Returns ``y`` ``[M * mb, ...]`` in microbatch order."""
    S = mesh.shape[axis]
    m_total = microbatches

    def shard_fn(R, params, x):
        x_all = C.all_gather(x, R, axis, 0, tiled=True)[0]   # on every stage
        mbs = x_all.shape[0] // m_total
        acts = x_all.new_zeros((S, mbs, *x_all.shape[1:]))
        outs = x_all.new_zeros((S, *x_all.shape))
        for t in range(S + m_total - 1):
            ys = []
            for s in range(S):
                mb_idx = t - s
                take = min(max(mb_idx, 0), m_total - 1)
                x_in = x_all[take * mbs:(take + 1) * mbs] if s == 0 \
                    else acts[s]
                y = stage_fn(unflatten(params, [a[s] for a in leaves(params)]),
                             x_in)
                ys.append(y if 0 <= mb_idx < m_total else acts[s])
            y = torch.stack(ys)
            # hand the activations to the next stage
            nxt = C.ppermute(y, R, axis, [(i, (i + 1) % S) for i in range(S)])
            # the last stage emits completed microbatches
            done = t - (S - 1)
            if 0 <= done < m_total:
                outs[S - 1, done * mbs:(done + 1) * mbs] = y[S - 1]
            acts = nxt
        # results live on the last stage; broadcast and reslice
        last = (C.axis_index(R, axis, x.device, outs.ndim - 1) == S - 1)
        outs = C.psum(torch.where(last, outs, 0), R, axis)
        return C.to_ranks(outs[0], R, P(axis))     # stage s: slice s

    def run(stage_params, x):
        R = C.Ranks.of(mesh, (axis,))
        y = shard_fn(R, stage_params, C.to_ranks(x, R, P(axis)))
        return C.from_ranks(y, R, P(axis))
    return run
