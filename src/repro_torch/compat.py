"""The rank-axis emulation of ``shard_map`` (the port's counterpart of
the reference's ``compat.py``, whose ``shard_map`` and ``axis_size``
paper over JAX versions).

The reference runs its mesh paths as ``shard_map`` bodies: one program
on every device of a mesh, with named-axis collectives between them.
The port runs every rank on one device: each mesh axis that a body uses
becomes a leading axis of its tensors, in mesh order, and each
collective becomes a tensor operation on that axis (:class:`Ranks`
names the leading axes). A leading axis of size 1 holds a value that is
the same on every rank of that axis (an input replicated over it, or
the result of a reduction over it); the collectives expand such an axis
where its ranks must differ.

* ``psum`` / ``pmax`` / ``pmean``: a sum, max or mean over the axis,
  seen by every rank (size 1 on the axis);
* ``psum_scatter(tiled)``: that sum, split into chunks by the rank's
  index;
* ``all_gather(tiled)``: the ranks' chunks concatenated, a reshape;
* ``all_to_all``: a transpose of the rank axis and the chunk axis;
* ``ppermute``: indexing the rank axis by the permutation;
* ``axis_index``: an ``arange`` over the axis.

Each collective reports its kind, one rank's result and its group to
the active ``launch.op_analysis`` counters through ``repro_torch._cost``
(the dry-run's collective bytes).

:func:`shard_map` splits global tensors into per-rank tensors by a
``PartitionSpec``-like tuple (:class:`P`) and joins the body's outputs
back. Only the axes a call's plan uses are emulated: along any other
mesh axis every rank computes the same thing, so computing it once is
the same result (the reference's bodies run no collective over an axis
their plan leaves out). Gradients are autograd's through these operations:
the gradient of the global function, which is what ``jax.grad`` gives
through a ``shard_map`` whose replicated outputs agree across ranks.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch import _cost


class P(tuple):
    """A partition spec: one entry a dimension, ``None`` (not split), an
    axis name, or a tuple of names (split over them, the first major).
    A one-name tuple is kept as the name, as ``PartitionSpec`` keeps it,
    so the two compare entry for entry."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1
            else tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class EmulatedMesh(NamedTuple):
    """A named grid of ranks with no devices behind it: the
    ``jax.sharding.Mesh`` of the reference (``axis_names``, ``shape``
    as a dict, ``size``)."""

    dims: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> tuple[str, ...]:
    """Every axis name a spec splits over, in its order."""
    return tuple(a for entry in spec for a in _names(entry))


class Ranks(NamedTuple):
    """The leading rank axes of an emulated per-rank tensor: their names
    in mesh order and their sizes."""

    names: tuple[str, ...]
    sizes: tuple[int, ...]

    @classmethod
    def of(cls, mesh, axes) -> "Ranks":
        """The axes ``axes`` of ``mesh``, put in the mesh's order."""
        axes = set(axes)
        unknown = axes - set(mesh.axis_names)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} are not in the mesh "
                             f"{mesh.axis_names}")
        names = tuple(a for a in mesh.axis_names if a in axes)
        return cls(names, tuple(mesh.shape[a] for a in names))

    @property
    def n(self) -> int:
        return len(self.names)

    def dims(self, axis) -> tuple[int, ...]:
        return tuple(self.names.index(a) for a in _names(axis))

    def size(self, axis) -> int:
        return math.prod(self.sizes[d] for d in self.dims(axis))


def axis_size(ranks: Ranks, axis) -> int:
    """The number of ranks along ``axis`` (a name or a tuple of them)."""
    return ranks.size(axis)


def axis_index(ranks: Ranks, axis: str, device=None,
               local_ndim: int = 0) -> torch.Tensor:
    """Each rank's index along ``axis``: int64, size ``n`` on that axis
    and 1 on the other rank axes, then ``local_ndim`` axes of 1."""
    shape = [1] * ranks.n + [1] * local_ndim
    d = ranks.dims(axis)[0]
    shape[d] = ranks.sizes[d]
    return torch.arange(ranks.sizes[d], device=device).reshape(shape)


def _full(x: torch.Tensor, ranks: Ranks, axis) -> torch.Tensor:
    """``x`` with the rank axes of ``axis`` at their full size (a
    replicated value is expanded, no copy)."""
    shape = list(x.shape)
    for d in ranks.dims(axis):
        shape[d] = ranks.sizes[d]
    return x.expand(shape)


def _counted(kind: str, out: torch.Tensor, ranks: Ranks,
             axis) -> torch.Tensor:
    """``out``, after reporting it to the active cost counters as one
    collective of ``kind`` over the ranks of ``axis``."""
    _cost.count_collective(kind, out, ranks.n, ranks.size(axis))
    return out


def _psum(x: torch.Tensor, ranks: Ranks, axis) -> torch.Tensor:
    return _full(x, ranks, axis).sum(ranks.dims(axis), keepdim=True)


def psum(x: torch.Tensor, ranks: Ranks, axis) -> torch.Tensor:
    return _counted("all-reduce", _psum(x, ranks, axis), ranks, axis)


def pmax(x: torch.Tensor, ranks: Ranks, axis) -> torch.Tensor:
    return _counted("all-reduce", _full(x, ranks, axis).amax(
        ranks.dims(axis), keepdim=True), ranks, axis)


def pmean(x: torch.Tensor, ranks: Ranks, axis) -> torch.Tensor:
    return _counted("all-reduce", _full(x, ranks, axis).mean(
        ranks.dims(axis), keepdim=True), ranks, axis)


def psum_scatter(x: torch.Tensor, ranks: Ranks, axis: str, dim: int,
                 tiled: bool = True) -> torch.Tensor:
    """The sum over ``axis``; rank i keeps chunk i of local dim ``dim``
    (tiled), or index i of a ``dim`` of the axis's size (not tiled)."""
    a, n = ranks.dims(axis)[0], ranks.size(axis)
    loc = ranks.n + dim
    s = _psum(x, ranks, axis)
    if tiled:
        if s.shape[loc] % n:
            raise ValueError(f"psum_scatter: dim {dim} of {s.shape[loc]} "
                             f"does not split over {n} ranks")
        s = s.unflatten(loc, (n, s.shape[loc] // n))
    elif s.shape[loc] != n:
        raise ValueError(f"psum_scatter: dim {dim} is {s.shape[loc]}, not "
                         f"the {n} ranks of {axis!r}")
    return _counted("reduce-scatter", s.transpose(a, loc).squeeze(loc),
                    ranks, axis)


def all_gather(x: torch.Tensor, ranks: Ranks, axis: str, dim: int,
               tiled: bool = True) -> torch.Tensor:
    """Every rank gets the ranks' tensors in rank order: concatenated
    along local dim ``dim`` (tiled) or stacked at ``dim`` (not)."""
    a = ranks.dims(axis)[0]
    loc = ranks.n + dim
    y = _full(x, ranks, axis).movedim(a, loc - 1)
    if tiled:
        y = y.flatten(loc - 1, loc)
    return _counted("all-gather", y.unsqueeze(a), ranks, axis)


def all_to_all(x: torch.Tensor, ranks: Ranks, axis: str, split_axis: int,
               concat_axis: int, tiled: bool = False) -> torch.Tensor:
    """``lax.all_to_all``: rank j gets chunk j of every rank's local dim
    ``split_axis``, in source-rank order along ``concat_axis``. Tiled,
    the dims keep their number (the split dim shrinks n-fold, the concat
    dim grows n-fold); not tiled, the split dim (of size n) goes and a
    source-rank dim of size n comes in at ``concat_axis``."""
    a, n = ranks.dims(axis)[0], ranks.size(axis)
    ls, lc = ranks.n + split_axis, ranks.n + concat_axis
    y = _full(x, ranks, axis)
    if tiled:
        if y.shape[ls] % n:
            raise ValueError(f"all_to_all: dim {split_axis} of "
                             f"{y.shape[ls]} does not split over {n} ranks")
        y = y.unflatten(ls, (n, y.shape[ls] // n)).transpose(a, ls)
        # the source-rank dim, now at ls, goes just before the concat dim
        return _counted("all-to-all", y.movedim(ls, lc).flatten(lc, lc + 1),
                        ranks, axis)
    if y.shape[ls] != n:
        raise ValueError(f"all_to_all: dim {split_axis} is {y.shape[ls]}, "
                         f"not the {n} ranks of {axis!r}")
    return _counted("all-to-all", y.transpose(a, ls).movedim(ls, lc), ranks,
                    axis)


def ppermute(x: torch.Tensor, ranks: Ranks, axis: str,
             perm) -> torch.Tensor:
    """Rank ``dst`` gets rank ``src``'s tensor for each ``(src, dst)``;
    a rank that is no destination gets zeros."""
    a, n = ranks.dims(axis)[0], ranks.size(axis)
    src_of = [-1] * n
    for src, dst in perm:
        src_of[dst] = src
    y = _full(x, ranks, axis).index_select(
        a, torch.tensor([max(s, 0) for s in src_of], device=x.device))
    if min(src_of) < 0:
        keep = torch.tensor([s >= 0 for s in src_of], device=x.device)
        shape = [1] * y.ndim
        shape[a] = n
        y = y * keep.reshape(shape).to(y.dtype)
    return _counted("collective-permute", y, ranks, axis)


def to_ranks(x: torch.Tensor, ranks: Ranks, spec) -> torch.Tensor:
    """Global ``x`` as per-rank tensors ``[*rank axes, *local]``: each
    dim split over the axes its spec entry names (a ``ValueError`` where
    it does not divide: padding would change the local shapes); a rank
    axis the spec does not name gets size 1 (replicated)."""
    spec = tuple(spec) + (None,) * (x.ndim - len(spec))
    shape, pos = [], {}
    for d, entry in enumerate(spec):
        names = _names(entry)
        split = math.prod(ranks.size(a) for a in names)
        if x.shape[d] % split:
            raise ValueError(
                f"dim {d} of {tuple(x.shape)} ({x.shape[d]}) does not "
                f"divide over the {split} ranks of {names}")
        for a in names:
            pos[a] = len(shape)
            shape.append(ranks.size(a))
        shape.append(x.shape[d] // split)
    present = [a for a in ranks.names if a in pos]
    y = x.reshape(shape).movedim([pos[a] for a in present],
                                 list(range(len(present))))
    for i, a in enumerate(ranks.names):
        if a not in pos:
            y = y.unsqueeze(i)
    return y


def from_ranks(y: torch.Tensor, ranks: Ranks, spec) -> torch.Tensor:
    """Per-rank ``y`` back to a global tensor: the inverse of
    :func:`to_ranks`. Along a rank axis the spec does not name, the
    ranks hold the same value and rank 0's is taken."""
    named = set(spec_axes(spec))
    shape = list(y.shape)
    for i, a in enumerate(ranks.names):
        if a in named:
            shape[i] = ranks.sizes[i]
    y = y.expand(shape)
    for i in reversed(range(ranks.n)):
        if ranks.names[i] not in named:
            y = y.select(i, 0)
    present = [a for a in ranks.names if a in named]
    k = len(present)
    local = y.shape[k:]
    spec = tuple(spec) + (None,) * (len(local) - len(spec))
    perm, out_shape = [], []
    for d, entry in enumerate(spec):
        names = _names(entry)
        perm += [present.index(a) for a in names]
        perm.append(k + d)
        out_shape.append(local[d] * math.prod(ranks.size(a) for a in names))
    return y.permute(perm).reshape(out_shape)


def shard_map(fn: Callable, mesh, in_specs, out_specs, axes) -> Callable:
    """``fn`` over per-rank tensors as a function of global ones: each
    argument split by its spec (:func:`to_ranks`), ``fn(ranks, *args)``
    called once on all ranks, each output joined by its spec
    (:func:`from_ranks`). The emulated axes are ``axes`` (put in mesh
    order): the body's collectives may run over them, and the specs name
    no other."""
    ranks = Ranks.of(mesh, axes)

    def run(*args):
        ranked = [to_ranks(x, ranks, s) for x, s in zip(args, in_specs)]
        out = fn(ranks, *ranked)
        if isinstance(out_specs, P):
            return from_ranks(out, ranks, out_specs)
        return tuple(from_ranks(o, ranks, s) for o, s in zip(out, out_specs))
    return run
