"""Dispatch-level cost counter for the dry-run and the roofline: the
port's counterpart of the reference's ``launch/hlo_analysis.py``.

The reference parses XLA's optimized HLO of a compiled step. The port
has no HLO: it counts what a step dispatches while it runs, on any
device (``meta`` traces shapes without allocating; the card and the CPU
run the step for real), inside ``with OpCounter() as c:``. The totals
are the reference's ``CompCost`` fields:

* ``flops``: 2·M·N·K for every dispatched product (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, ``dot``, ``mv``; the einsums lower to these) and
  for convolutions (output elements x the input channels of a group x
  the kernel's elements; the backward's gradients as many again), seen
  by a ``TorchDispatchMode`` below autograd, so the backward's products
  count too. ``flops_by_dtype`` splits them by the operands' type.
* The attention is counted by formula, not by what implements it: the
  Hopper kernels launch through ``ctypes`` (``kernels/build.py``), which
  no dispatch mode sees, and the plain version (on the CPU and on
  ``meta``) computes the masked pairs that the kernel skips. So
  ``kernels.ops.fused_attention`` (``models.layers.flash_attention``'s
  every call) and ``kernels.flash.FlashAttention.backward`` call
  ``count_attention`` and run their implementation under
  ``uncounted`` (both in ``repro_torch._cost``, the registry below the
  kernels and ``compat``, which this counter joins while it is on): the forward is two products of hd a visible pair
  (4·hd·pairs, pairs from :func:`attention_work`), the backward four
  (dP, dv, dq and dk: 8·hd·pairs; the kernel's recompute of the logits
  is not counted). The count is the same on the card, on the CPU and on
  ``meta``.
* ``bytes``: each op's result bytes counted once (the reference's
  proxy: every read is some producer's write); views, allocations
  (``empty*``) and aliases add nothing, an in-place op adds what it
  writes. The attention adds its operands and its result: q and the
  output (forward), q, the output, dO and dq (backward), and k and v
  (and dk, dv) over the keys some query sees.
* ``coll_bytes`` / ``coll_count`` by kind, and ``coll_detail`` ``(kind,
  per-rank shape, group size, wire bytes)``: each collective of
  ``compat`` (``psum``, ``pmax``, ``pmean``: all-reduce;
  ``psum_scatter``: reduce-scatter; ``all_gather``, ``all_to_all``,
  ``ppermute``: collective-permute) reports its kind, one rank's result
  and its group; the wire bytes per device follow :func:`_ring_bytes`
  (the reference's ring formulas, on the per-rank result's bytes as the
  reference takes the HLO result shape). One emulated call is one
  collective, as one op of the per-device program.
* ``coll_implied``: the collectives GSPMD inserts for the specs, which
  the emulation never runs (:func:`implied_collectives`).

Loop-awareness comes free: eager execution runs every layer and every
chunk, so nothing is multiplied by a trip count (the reference reads
``while`` trip counts because XLA's cost analysis counts a loop body
once).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import _cost
from repro_torch._cost import _add, _dtype_name, _ring_bytes
from repro_torch._cost import attention_work  # noqa: F401  (re-exported)

aten = torch.ops.aten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# ops whose results are not written by them: allocations and aliases
_NO_BYTES = {aten.empty, aten.empty_like, aten.empty_strided,
             aten.new_empty, aten.new_empty_strided, aten._unsafe_view,
             aten.lift_fresh, aten.detach, aten.alias,
             aten._local_scalar_dense}


@dataclass
class CompCost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: dict = field(default_factory=dict)   # kind -> wire bytes
    coll_count: dict = field(default_factory=dict)
    coll_detail: list = field(default_factory=list)  # (kind, shape, n, wire)
    coll_implied: dict = field(default_factory=dict)  # kind -> wire bytes
    flops_by_dtype: dict = field(default_factory=dict)
    attention_flops: float = 0.0      # of flops: the attention's formula
    devices: set = field(default_factory=set)        # result device types


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


def _prod(shape) -> int:
    return math.prod(shape)


def _conv_flops(x_shape, w_shape, out_shape, transposed: bool) -> int:
    """2 x output elements x (input channels of a group x kernel
    elements); transposed: the same with input and output swapped."""
    kernel = _prod(w_shape[2:])
    if transposed:
        return 2 * _prod(x_shape) * w_shape[1] * kernel
    return 2 * _prod(out_shape) * w_shape[1] * kernel


def _product_flops(func, args, out) -> int | None:
    """FLOPs of a dispatched product, or None for any other op."""
    p = func.overloadpacket
    if p in (aten.mm, aten.bmm):
        a, b = args[0].shape, args[1].shape
        return 2 * _prod(a) * b[-1]
    if p in (aten.addmm, aten.baddbmm):
        a, b = args[1].shape, args[2].shape
        return 2 * _prod(a) * b[-1]
    if p is aten.dot:
        return 2 * args[0].numel()
    if p is aten.mv:
        return 2 * args[0].numel()
    if p is aten.convolution:
        return _conv_flops(args[0].shape, args[1].shape, out.shape,
                           bool(args[6]))
    if p is aten.convolution_backward:
        grad_out, x, w = args[0], args[1], args[2]
        transposed, mask = bool(args[7]), args[10]
        one = _conv_flops(x.shape, w.shape, grad_out.shape, transposed)
        return one * (int(mask[0]) + int(mask[1]))
    return None


def _writes(func) -> bool:
    """Whether ``func``'s results are memory it writes: not a view, an
    allocation or an alias of an input."""
    if func.overloadpacket in _NO_BYTES:
        return False
    for ret in func._schema.returns:
        info = ret.alias_info
        if info is not None and not info.is_write:
            return False            # a view of an input
    return True


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: step(...)`` counts what the step
    dispatches into ``c.cost`` (:class:`CompCost`); see the module
    docstring. Counters nest: each active one counts."""

    def __init__(self):
        super().__init__()
        self.cost = CompCost()
        self.paused = 0

    def __enter__(self):
        _cost._ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _cost._ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.paused:
            return out
        flops = _product_flops(func, args, out)
        if flops is not None:
            self.cost.flops += flops
            _add(self.cost.flops_by_dtype, _dtype_name(args[0].dtype),
                 flops)
        if _writes(func):
            for t in _tensors(out):
                self.cost.bytes += t.numel() * t.element_size()
                self.cost.devices.add(t.device.type)
        return out


def _spec_names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def implied_collectives(params: list, mesh, data_axes, kind: str,
                        remat: bool = True) -> dict:
    """The collectives GSPMD inserts for the parameters' specs, which the
    emulation never runs, as wire bytes per device by kind. For each
    leaf whose spec names data axes (FSDP: ``transformer.param_shardings``
    shards the non-model dim over them), with ``n`` the data ranks it is
    split over and ``g`` = its bytes over the ranks of its other named
    axes (what one device holds after the gather):

    * an all-gather of result ``g`` over ``n`` at each use:
      once a step for prefill and decode; for a train step at the
      forward, the backward, and (``remat``) the recomputed forward;
    * in a train step, one reduce-scatter of its gradient, result
      ``g / n`` over ``n`` (the reference's ring formula on the result).

    ``params``: ``(spec, tensor)`` of each parameter (``compat.P``
    specs; the tensors may be ``meta``)."""
    data = set(data_axes)
    uses = (3 if remat else 2) if kind == "train" else 1
    out: dict = {}
    for spec, shape in params:
        names = [a for e in spec for a in _spec_names(e)]
        n = math.prod(mesh.shape[a] for a in names if a in data)
        if n <= 1:
            continue
        other = math.prod(mesh.shape[a] for a in names if a not in data)
        g = shape.numel() * shape.element_size() / other
        _add(out, "all-gather", uses * _ring_bytes("all-gather", g, n))
        if kind == "train":
            _add(out, "reduce-scatter",
                 _ring_bytes("reduce-scatter", g / n, n))
    return out
