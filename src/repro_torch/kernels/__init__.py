"""Hand-written Hopper kernels of the port and their plain versions.

* ``sort.bitonic_sort`` — batched shared-memory bitonic sort (CUDA);
* ``coalesce_kernel.coalesce`` — batched run coalescing (CUDA);
* ``fused_round.fused_sort_pack`` — the per-round drain: sort + window
  and mask, each tile walking the sorted list once (CUDA);
* ``fused_round.zero_skip_encode`` / ``zero_skip_decode`` — the rle
  codec's wire on the slow hop: per-row zero-skip compaction (chunks
  chained by a decoupled look-back) and its inverse scatter, at every
  element width of 1, 2, 4 and 8 bytes (CUDA);
* ``pack.pack`` — gather-form pack of sorted requests into a window
  (CUDA, the drain's tile kernel without sort and mask);
* ``pack.route_spans`` — the round engine's element routing: batched
  rows of sorted, disjoint spans copied into padded rows (CUDA, the same
  tile walk at base 0 with a ragged last tile);
* ``flash.flash_attention_fused`` — online-softmax GQA attention with
  causal, window, softcap and kv_len masks, the serving path's
  attention (CUDA, three routes: ``tc_prefill`` and ``split_decode`` for
  bf16, ``tc_f32`` for f32, all on the tensor cores);
* ``flash.flash_attention_bwd`` — its gradient (dq, dk, dv), the
  training path's attention backward, behind the autograd function
  ``flash.FlashAttention`` (CUDA, f32 and bf16);
* ``ref`` — the plain PyTorch versions the wrappers run on the CPU;
* ``ops`` — padding, chunking and RequestList integration;
* ``build`` — the nvcc build and ctypes loading, at first launch.

Each wrapper counts the calls that launched its kernel in a plain
integer attribute, ``<wrapper>.launches``; the attention also counts
them by route, in ``flash_attention_fused.launches_by_route``, and the
attention and its backward count their f32 p.v variant's launches
(``REPRO_PERF_OPTS=0``) in ``.launches_pv32``.
"""
from __future__ import annotations

from repro_torch.kernels.coalesce_kernel import coalesce
from repro_torch.kernels.flash import (flash_attention_bwd,
                                      flash_attention_fused)
from repro_torch.kernels.fused_round import (fused_sort_pack,
                                            zero_skip_decode,
                                            zero_skip_encode)
from repro_torch.kernels import pack as _pack_module   # keeps .pack a module
from repro_torch.kernels.sort import bitonic_sort

KERNELS = (bitonic_sort, coalesce, fused_sort_pack, zero_skip_encode,
           zero_skip_decode, _pack_module.pack, _pack_module.route_spans,
           flash_attention_fused, flash_attention_bwd)


def launch_counts() -> dict[str, int]:
    """Launch count of every kernel wrapper, by name."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        for counts in (getattr(k, "launches_by_route", {}),
                       getattr(k, "launches_pv32", {})):
            for key in counts:
                counts[key] = 0
