"""Fused flash attention: the port of
``repro.kernels.flash.flash_attention_fused``.

Online-softmax GQA attention over ``[B, S, H, hd]`` tensors with causal
masking (and ``q_offset`` for decode and continuation), a sliding
``window``, a ``logit_cap`` tanh softcap and a ``kv_len`` bound on the
keys; m, l and the accumulator in f32, the output in the input type.
The TPU kernel keeps one (batch x kv head, q block) program's logits and
probabilities in VMEM; the Hopper kernel (``csrc/flash.cu``) keeps them
in shared memory and registers of one CTA, with the g query heads of a
kv head in the same CTA, and walks only the key tiles its rows can see.
It ports the semantics of the attention the reference's model runs
(``layers.flash_attention`` at its default), which the kernel stands in
for on the card: probabilities and values are rounded to bf16 for the
p.v product, summed in f32, for f32 inputs too. The Pallas kernel keeps
p.v in f32, so for f32 inputs this kernel is less precise than the one
it replaces (the difference is within the reference's 5e-3 f32
tolerance of the two).

``flash_attention_fused`` keeps the reference's contract (Sq and Skv
divide by the block sizes); the Hopper kernel's own tiles take ragged
edges, so ``flash_attention_ragged`` is the same call on any Sq and Skv,
and the model's decode reads its cache in place through it. On a CPU
tensor both run the plain version,
:func:`repro_torch.kernels.ref.flash_attention_ref`.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

BLOCK_Q = 256
BLOCK_KV = 512
MAX_HEAD_DIM = 256
ROWS_PER_CTA = 64      # (query, head) rows per CTA in csrc/flash.cu
MAX_GRID_Y = 65535
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_fused(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: int | None = None,
                          logit_cap: float | None = None,
                          q_offset: int = 0, kv_len: int | None = None,
                          block_q: int = BLOCK_Q,
                          block_kv: int = BLOCK_KV) -> torch.Tensor:
    """Fused attention. q: ``[B, Sq, Hq, hd]``; k, v: ``[B, Skv, Hkv, hd]``.

    Sq must divide by block_q and Skv by block_kv, as in the reference
    (``ops.fused_attention`` takes any shape). Otherwise
    :func:`flash_attention_ragged`.
    """
    if q.shape[1] % block_q or k.shape[1] % block_kv:
        raise ValueError("pad Sq/Skv to the block sizes")
    return flash_attention_ragged(q, k, v, causal=causal, window=window,
                                  logit_cap=logit_cap, q_offset=q_offset,
                                  kv_len=kv_len)


def flash_attention_ragged(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int | None = None,
                           logit_cap: float | None = None,
                           q_offset: int = 0,
                           kv_len: int | None = None) -> torch.Tensor:
    """The fused attention on any Sq and Skv, keys bounded by ``kv_len``
    (None: Skv). ``q_offset`` and ``kv_len`` are plain ints passed to the
    kernel at launch. CUDA tensors launch the kernel (counted in
    ``flash_attention_fused.launches``); CPU tensors run
    ``flash_attention_ref``.
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
                                   kv_len=kv_len)
    build.require_cuda("flash_attention_fused", q, k, v)
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fused takes {DTYPES} on the card, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} > {MAX_HEAD_DIM}")
    if -(-sq * (hq // hkv) // ROWS_PER_CTA) > MAX_GRID_Y:
        raise ValueError(f"{sq} queries x {hq // hkv} heads per kv head "
                         "exceed the kernel's grid")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be >= 1 or None")
    if logit_cap is not None and logit_cap <= 0:
        raise ValueError(f"logit_cap {logit_cap} must be > 0 or None")
    out = torch.empty_like(q)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            skv, hq, hkv, hd, 1.0 / math.sqrt(hd), int(causal),
            0 if window is None else int(window),
            0.0 if logit_cap is None else float(logit_cap), int(q_offset),
            kv_len, int(q.dtype == torch.bfloat16), build.stream_of(q))
    build.check(lib, "flash_attention_fused", rc)
    flash_attention_fused.launches += 1
    return out


flash_attention_fused.launches = 0
