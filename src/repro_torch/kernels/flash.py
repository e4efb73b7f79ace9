"""Fused flash attention: the port of
``repro.kernels.flash.flash_attention_fused`` (``src/repro/kernels/
flash.py:92``).

Online-softmax GQA attention over ``[B, S, H, hd]`` tensors with causal
masking (and ``q_offset`` for decode and continuation), a sliding
``window``, a ``logit_cap`` tanh softcap and a ``kv_len`` bound on the
keys; m, l and the accumulator in f32, the output in the input type.
It ports the semantics of the attention the reference's model runs
(``layers.flash_attention``), which the kernel stands in for on the
card. At the model's default, probabilities and values are rounded to
bf16 for the p.v product, summed in f32, for f32 inputs too. Under
``REPRO_PERF_OPTS=0`` the model keeps p.v in f32, as the Pallas kernel
does; every route has that variant too (``pv32``): ``tc_prefill`` and
``split_decode`` add a second bf16 product of ``bf16(p - bf16(p))``
(the values are bf16 already, so p.v then carries p to about 2^-17),
``tc_f32`` takes p.v as a split TF32 product of the f32 p and v (three
products, as its q.k). ``pv32`` is an argument (default False):
``ops.fused_attention`` reads the setting once a call and passes it
down, to the backward too.

On the card every call takes one of three routes, a pure function of
the shapes and the type (:func:`_route`); (query, head) pairs of one
(batch, kv head) are flattened into rows ``s * g + h``, so the g query
heads of a kv head share every K/V tile:

* ``"tc_prefill"`` (``csrc/flash.cu``): bf16 with more than
  ``SPLIT_MAX_ROWS`` rows per (batch, kv head). Bound by operations: both
  products on the tensor cores through ``wgmma`` (two warpgroups, 128
  rows a CTA), K and V streamed as bf16 through a two-stage
  ``cp.async`` ring into 128-byte-swizzled shared tiles (element by
  element where a row does not start on 16 bytes: a head dim that is not
  a multiple of 8, or a tensor off a 16-byte boundary), masks only on
  edge tiles.
* ``"split_decode"`` (``csrc/flash_decode.cu``): bf16 with at most
  ``SPLIT_MAX_ROWS`` rows, i.e. decode steps. Bound by bytes: the visible
  keys of each (batch, kv head) are cut into :func:`_split_chunks`
  chunks so the whole card reads the cache once (``mma.sync`` products,
  each warp a quarter of the head dim); each chunk writes a partial
  (m, l, acc) to f32 scratch and a second launch merges them (the
  algorithm of :func:`repro_torch.kernels.ref.flash_attention_split_ref`).
* ``"tc_f32"`` (``csrc/flash.cu``): f32. Bound by operations: q.k as
  split TF32 products on the tensor cores (``mma.sync``; each f32
  operand as two TF32 halves, three products: about f32's accuracy; a
  single TF32 product holds the f32 check on unit-sized logits but not
  on logits four times larger, ``tests/test_torch_flash_f32.py``), p.v
  as an exact bf16 product of the probabilities and values the function
  rounds to bf16; 64 rows a CTA of 8 warps, 32-key tiles, element-wise
  loads where a row does not start on 16 bytes. A model of its
  arithmetic is :func:`repro_torch.kernels.ref.flash_attention_tc_f32_ref`.

The caller's route is the one launched; nothing falls back. Each call
counts one launch in ``flash_attention_fused.launches`` and one in
``flash_attention_fused.launches_by_route[route]``, and a call of the
f32 p.v variant one more in ``launches_pv32[route + "_pv32"]``.

``flash_attention_fused`` keeps the reference's contract (Sq and Skv
divide by the block sizes); the Hopper kernels' tiles take ragged
edges, so ``flash_attention_ragged`` is the same call on any Sq and Skv,
and the model's decode reads its cache in place through it. On a CPU
tensor both run the plain version,
:func:`repro_torch.kernels.ref.flash_attention_ref`.

The gradient (:class:`FlashAttention`, an autograd function whose
forward is the routed kernel above) comes from
:func:`flash_attention_bwd` (``csrc/flash_bwd.cu``): the gradient of the
model's attention, which the reference takes from XLA's autodiff (it
has no Pallas backward). Three launches, no atomics: a pass that
computes each row's max, then its sum l of exp(x - max) (in f64,
rounded once), and writes ``dout / l`` and ``D = (dout / l) . out``
(and, up to ``BWD_DOTS_MAX_BYTES``, each pair's q . k for the other
passes, which recompute it past that), one CTA per 64 rows for dq, one
per 64 keys for dk and dv (rows streamed 32 at a time). dP, dk and dq
run on the tensor cores (``mma.sync`` TF32, each f32 operand split into
two TF32 halves); for f32 inputs the logits and dv are f32 FMA chains
in the plain version's order, which the f32 check needs (the gradient
rounds bf16(p~) and dP, so the logits must keep the plain version's
bits); for bf16 inputs every product is on the tensor cores. A model of
its arithmetic is
:func:`repro_torch.kernels.ref.flash_attention_bwd_split_ref`. CPU
tensors run :func:`repro_torch.kernels.ref.flash_attention_bwd_ref`.
Its f32 p.v variant (``pv32``, the gradient of the forward's) rounds
nothing to bf16: dP takes v whole (split TF32 for f32 inputs), dv takes
p~ whole (split TF32 for bf16 inputs; f32 inputs keep the FMA chain),
and neither dP nor dv is rounded.
"""
from __future__ import annotations

import math

import torch

from repro_torch import _cost
from repro_torch.kernels import build
from repro_torch.kernels.ref import (F32_ROWS, flash_attention_bwd_ref,
                                     flash_attention_ref)

BLOCK_Q = 256
BLOCK_KV = 512
MAX_HEAD_DIM = 256
DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("tc_prefill", "split_decode", "tc_f32")
PV32_ROUTES = tuple(r + "_pv32" for r in ROUTES)   # the f32 p.v variants
_ROUTE_CODE = {"tc_f32": 0, "tc_prefill": 1, "split_decode": 2}
# tc_prefill: (query, head) rows a CTA; a 1-D grid
TC_ROWS_PER_CTA = 128
MAX_GRID_X = 2 ** 31 - 1
# split_decode: rows per (batch, kv head) it takes (one 16-row mma tile),
# the CTAs its grid aims at (two per SM of the H100's 132), the fewest
# keys a chunk (two 64-key tiles)
SPLIT_MAX_ROWS = 16
SPLIT_TARGET_CTAS = 264
SPLIT_MIN_KEYS = 128


def _route(b: int, sq: int, hq: int, hkv: int, hd: int, dtype) -> str:
    """The kernel route of a call on the card, from its shapes and type
    alone: ``"tc_f32"`` for f32; for bf16 ``"split_decode"`` when a
    (batch, kv head) has at most ``SPLIT_MAX_ROWS`` (query, head) rows
    (``sq * hq / hkv``), else ``"tc_prefill"``. Raises for what no route
    takes: another type (``TypeError``), a head dim outside [1, 256] or a
    grid the card cannot launch (``ValueError``). Every head dim in range
    and every alignment is taken: every route loads rows that do not
    start on 16 bytes element by element."""
    if dtype not in DTYPES:
        raise TypeError(f"flash_attention_fused takes {DTYPES} on the card, "
                        f"got {dtype}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} not in [1, {MAX_HEAD_DIM}]")
    rows = sq * (hq // hkv)
    if dtype == torch.float32:
        # tc_f32: F32_ROWS (query, head) rows a CTA, a 1-D grid
        if b * hkv * -(-rows // F32_ROWS) > MAX_GRID_X:
            raise ValueError(f"{b} x {hkv} x {rows} rows exceed the grid")
        return "tc_f32"
    if rows <= SPLIT_MAX_ROWS:
        return "split_decode"
    if b * hkv * -(-rows // TC_ROWS_PER_CTA) > MAX_GRID_X:
        raise ValueError(f"{b} x {hkv} x {rows} rows exceed the grid")
    return "tc_prefill"


def _split_chunks(b: int, hkv: int, skv: int) -> int:
    """Chunks per (batch, kv head) of a ``split_decode`` call: enough for
    ``SPLIT_TARGET_CTAS`` CTAs, at most one per ``SPLIT_MIN_KEYS`` keys
    of the cache, at least 1. A function of shapes only: the kernel
    cuts the visible keys (from ``q_offset`` and ``kv_len``) into this
    many chunks of whole 64-key tiles, with no host synchronisation."""
    return max(1, min(-(-SPLIT_TARGET_CTAS // (b * hkv)),
                      -(-skv // SPLIT_MIN_KEYS)))


def flash_attention_fused(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: int | None = None,
                          logit_cap: float | None = None,
                          q_offset: int = 0, kv_len: int | None = None,
                          block_q: int = BLOCK_Q,
                          block_kv: int = BLOCK_KV,
                          pv32: bool = False) -> torch.Tensor:
    """Fused attention. q: ``[B, Sq, Hq, hd]``; k, v: ``[B, Skv, Hkv, hd]``.

    Sq must divide by block_q and Skv by block_kv, as in the reference
    (``ops.fused_attention`` takes any shape). Otherwise
    :func:`flash_attention_ragged`.
    """
    if q.shape[1] % block_q or k.shape[1] % block_kv:
        raise ValueError("pad Sq/Skv to the block sizes")
    return flash_attention_ragged(q, k, v, causal=causal, window=window,
                                  logit_cap=logit_cap, q_offset=q_offset,
                                  kv_len=kv_len, pv32=pv32)


def flash_attention_ragged(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int | None = None,
                           logit_cap: float | None = None,
                           q_offset: int = 0,
                           kv_len: int | None = None,
                           pv32: bool = False) -> torch.Tensor:
    """The fused attention on any Sq and Skv, keys bounded by ``kv_len``
    (None: Skv). ``q_offset`` and ``kv_len`` are plain ints passed to the
    kernel at launch. CUDA tensors launch the route :func:`_route`
    names (counted in ``flash_attention_fused.launches`` and
    ``.launches_by_route``; its f32 p.v variant where ``pv32``, also
    in ``.launches_pv32``) or raise; CPU tensors run
    ``flash_attention_ref`` of the same variant.
    """
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape != (b, skv, hkv, hd) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / "
                         f"v {tuple(v.shape)} mismatch")
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    kv_len = skv if kv_len is None else min(int(kv_len), skv)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   logit_cap=logit_cap, q_offset=q_offset,
                                   kv_len=kv_len, pv32=pv32)
    build.require_cuda("flash_attention_fused", q, k, v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fused takes one type, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    route = _route(b, sq, hq, hkv, hd, q.dtype)
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be >= 1 or None")
    if logit_cap is not None and logit_cap <= 0:
        raise ValueError(f"logit_cap {logit_cap} must be > 0 or None")
    out = torch.empty_like(q)
    n_chunks, scratch = 0, None
    if route == "split_decode":
        n_chunks = _split_chunks(b, hkv, skv)
        scratch = torch.empty(b * hkv * n_chunks * sq * (hq // hkv) * (hd + 2),
                              dtype=torch.float32, device=q.device)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, sq, skv, hq,
            hkv, hd, 1.0 / math.sqrt(hd), int(causal),
            0 if window is None else int(window),
            0.0 if logit_cap is None else float(logit_cap), int(q_offset),
            kv_len, _ROUTE_CODE[route], n_chunks, int(pv32),
            build.stream_of(q))
    build.check(lib, "flash_attention_fused", rc)
    flash_attention_fused.launches += 1
    flash_attention_fused.launches_by_route[route] += 1
    if pv32:
        flash_attention_fused.launches_pv32[route + "_pv32"] += 1
    return out


flash_attention_fused.launches = 0
flash_attention_fused.launches_by_route = dict.fromkeys(ROUTES, 0)
flash_attention_fused.launches_pv32 = dict.fromkeys(PV32_ROUTES, 0)

# flash_attention_bwd: keys a dk/dv CTA, rows a stats or dq CTA, and
# the grids' y limit
BWD_KEYS_PER_CTA = 64
BWD_ROWS_PER_CTA = 64
BWD_MAX_GRID_Y = 65535


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        logit_cap: float | None = None, q_offset: int = 0,
                        kv_len: int | None = None, pv32: bool = False):
    """The gradient of :func:`flash_attention_ragged` at ``(q, k, v)``
    against ``dout``, given its output ``out``: ``(dq, dk, dv)`` in the
    input type, for the forward's p.v variant ``pv32``. CUDA tensors launch ``csrc/flash_bwd.cu`` (counted in
    ``flash_attention_bwd.launches``, one a call, and the f32 p.v
    variant also in ``.launches_pv32["bwd_pv32"]``) or raise; CPU
    tensors run ``ref.flash_attention_bwd_ref``. Pairs a row cannot see
    get no gradient, and neither does a row that sees no key."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape != (b, skv, hkv, hd) or v.shape != k.shape \
            or out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} / out {tuple(out.shape)} / dout "
                         f"{tuple(dout.shape)} mismatch")
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    kv_len = skv if kv_len is None else min(int(kv_len), skv)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, dout, causal=causal,
                                       window=window, logit_cap=logit_cap,
                                       q_offset=q_offset, kv_len=kv_len,
                                       pv32=pv32)
    build.require_cuda("flash_attention_bwd", q, k, v, out, dout)
    if any(t.dtype != q.dtype for t in (k, v, out, dout)) \
            or q.dtype not in DTYPES:
        raise TypeError(f"flash_attention_bwd takes one type of {DTYPES}, "
                        f"got {[t.dtype for t in (q, k, v, out, dout)]}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} not in [1, {MAX_HEAD_DIM}]")
    if -(-sq * (hq // hkv) // BWD_ROWS_PER_CTA) > BWD_MAX_GRID_Y \
            or -(-skv // BWD_KEYS_PER_CTA) > BWD_MAX_GRID_Y:
        raise ValueError(f"{sq} x {hq // hkv} rows or {skv} keys exceed the "
                         "backward kernel's grid")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be >= 1 or None")
    if logit_cap is not None and logit_cap <= 0:
        raise ValueError(f"logit_cap {logit_cap} must be > 0 or None")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if b == 0 or hkv == 0 or hd == 0:
        return dq, dk, dv
    if sq == 0 or skv == 0:
        return dq, dk.zero_(), dv.zero_()
    scratch = bwd_scratch(q, skv)
    _launch_bwd(q, k, v, out, dout, (dq, dk, dv), scratch,
                dict(causal=causal, window=window, logit_cap=logit_cap,
                     q_offset=q_offset, kv_len=kv_len, pv32=pv32),
                BWD_ALL_PASSES)
    flash_attention_bwd.launches += 1
    if pv32:
        flash_attention_bwd.launches_pv32["bwd_pv32"] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_pv32 = {"bwd_pv32": 0}

# the backward's launches as a mask: 1 stats, 2 dq, 4 dk/dv
BWD_ALL_PASSES = 7
# the backward keeps the logits' q . k (f32, one word a row and key,
# keys rounded up to the stats pass's tile of BWD_DOTS_KEYS) from its
# stats pass for the other two where that takes at most this many
# bytes; past it each pass recomputes them
BWD_DOTS_MAX_BYTES = 1 << 32
BWD_DOTS_KEYS = 64


def bwd_scratch(q: torch.Tensor, skv: int):
    """The backward's f32 scratch for ``q``'s shape against ``skv`` keys:
    dO' (q's layout), four words a row (m, D, dm, argmax), and the kept
    q . k (``[b, hkv, sq * g, keys rounded up to BWD_DOTS_KEYS]``) or
    None past ``BWD_DOTS_MAX_BYTES``."""
    b, sq, hq, _ = q.shape
    n_dots = b * hq * sq * (-(-skv // BWD_DOTS_KEYS) * BWD_DOTS_KEYS)
    return (torch.empty(q.shape, dtype=torch.float32, device=q.device),
            torch.empty((b, sq, hq, 4), dtype=torch.float32,
                        device=q.device),
            torch.empty(n_dots, dtype=torch.float32, device=q.device)
            if 4 * n_dots <= BWD_DOTS_MAX_BYTES else None)


def _launch_bwd(q, k, v, out, dout, grads, scratch, kw, passes) -> None:
    """``csrc/flash_bwd.cu`` on checked CUDA tensors: the launches of
    ``passes`` (``BWD_ALL_PASSES`` for the gradient; one pass at a time
    times a pass once a full call has filled ``scratch``). ``kv_len`` in
    ``kw`` is an int <= Skv; ``kw["pv32"]`` (absent: False) picks the
    f32 p.v variant. Counts nothing."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    window, cap = kw["window"], kw["logit_cap"]
    lib = build.load_library()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention_bwd(
            *(None if t is None else t.data_ptr()
              for t in (q, k, v, out, dout, *grads, *scratch)),
            b, sq, skv, hq, hkv, hd, 1.0 / math.sqrt(hd), int(kw["causal"]),
            0 if window is None else int(window),
            0.0 if cap is None else float(cap), int(kw["q_offset"]),
            kw["kv_len"], int(q.dtype == torch.bfloat16), passes,
            int(kw.get("pv32", False)), build.stream_of(q))
    build.check(lib, "flash_attention_bwd", rc)


class FlashAttention(torch.autograd.Function):
    """Attention with its gradient: the forward is
    :func:`flash_attention_ragged` (the routed kernel on the card, the
    plain version on the CPU), the backward :func:`flash_attention_bwd`
    (the backward kernel on the card, the plain backward on the CPU), both
    of the p.v variant ``pv32``. On
    ``meta`` tensors (a dry-run's trace) both give their results' shapes
    and types alone: the output is q's, the gradients the inputs'."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_cap, q_offset, kv_len,
                pv32=False):
        if q.device.type == "meta":
            out = torch.empty_like(q)
        else:
            out = flash_attention_ragged(q, k, v, causal=causal,
                                         window=window, logit_cap=logit_cap,
                                         q_offset=q_offset, kv_len=kv_len,
                                         pv32=pv32)
        ctx.save_for_backward(q, k, v, out)
        ctx.kw = dict(causal=causal, window=window, logit_cap=logit_cap,
                      q_offset=q_offset, kv_len=kv_len, pv32=pv32)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        kw = dict(ctx.kw)
        pv32 = kw.pop("pv32")
        _cost.count_attention(
            q, k, causal=kw["causal"], window=kw["window"],
            q_offset=kw["q_offset"], kv_len=kw["kv_len"], backward=True)
        with _cost.uncounted():
            if q.device.type == "meta":
                dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            else:
                dq, dk, dv = flash_attention_bwd(q, k, v, out,
                                                 dout.contiguous(), **kw,
                                                 pv32=pv32)
        return dq, dk, dv, None, None, None, None, None, None
