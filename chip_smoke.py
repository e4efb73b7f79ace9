#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version at the shapes the
main path gives it (exact equality for the I/O kernels, which move
words and do no arithmetic on them; for attention every element within
5e-3 (f32) or 8e-3 (bf16, one bf16 ulp) and a relative L2 distance of at
most 1e-2, with planted faults shown to fail that limit; the zero-skip
pair also at 1-, 2- and 8-byte elements; coalesce also on rows whose
entries are all live and on rows whose int32 ends wrap past 2^31 - 1;
``route_spans`` on the spans of one write of ``portbench``'s class D
BT-IO cell, at its three routing widths, also against the torch body it
replaces), checks small writes and reads
with every slow-hop codec on the card against the CPU (rle also on
bfloat16 and uint8 payloads), then drives the main paths:

* on the BTIO deployment (16 nodes x 64 ranks, one global aggregator per
  node, a 512 MiB file, 32 rounds of 1 MiB windows) with
  ``kernel_fusion="fused_round"``: the two-phase and the TAM collective
  write (``make_twophase_write``, ``make_tam_write(use_kernels=True)``);
  the same two writes with ``slow_hop_codec="rle"`` on a payload whose
  8-element cells are half zero (a sparse checkpoint page), whose wire
  the zero-skip kernels encode and decode; the two-phase and the TAM
  collective read with ``"rle"`` (``make_twophase_read``,
  ``make_tam_read``), reading that file back;
* on the same mesh, the paper's other patterns: E3SM-G (1024 interleaved
  requests of 512 B a rank, 128 int32 elements each) through both
  writes, and sparse checkpoint pages (256 pages of 2048 B a rank, 75%
  all zero, uint8 elements) through the TAM write with ``"rle"`` and its
  TAM read, each file equal to ``write_reference`` with zero drops;
* the host layer: ``checkpoint.HostCollectiveIO`` on the card at 1024
  ranks (E3SM-G, a 64 MiB file) writing with both methods single shot
  and in 1 MiB windows at depth 2 (each aggregator's image built by the
  ``pack`` kernel), with TAM once more with ``"rle"`` on the slow hop
  (encoded on the host), its read, and the multi-process transport at 16
  ranks (workers forked after CUDA is in use) against the in-process
  executor's segments;
* greedy serving of gemma2-9b at full width and depth (42 layers, bf16
  weights from a seeded generator) through ``launch.serve.generate``
  and the model's prefill and decode: batch 4 x 32 prompt tokens x 16
  new tokens, and one 8192-token prompt followed by 16 decode steps,
  every attention through the flash kernel (the prefill on its
  ``tc_prefill`` route, the decode steps on ``split_decode``, which the
  run requires); its logits are checked
  against ``forward`` and against attention forced through the plain
  version, and the attention of its first local and first global layer
  against the plain version, where planted faults must fail;
* training with checkpoint and restart (``phase_train``): the attention
  backward kernel (``csrc/flash_bwd.cu``) held against the autograd
  gradient of the plain attention at the training shapes, f32 and bf16,
  with planted faults that must fail and bit-equal repeats, timed pass
  by pass, with SDPA's backward beside it as a yardstick; then
  gemma2-9b at full width cut to 2 layers, f32 parameters, batch 1 x
  4096 tokens, through ``launch.train.build_training``: 4 uninterrupted
  steps, and a run that saves a TAM checkpoint at step 2 (``pack``
  builds its images), loses a host, restarts at ``find_restart_step``,
  restores the state byte for byte and resumes to the control's losses;
  the save's largest ``pack`` call (a 1 GiB window of a domain image)
  is held to ``pack_ref`` exactly and timed;
* serving of the moe and ssm families through the same traffic as
  gemma2's: kimi-k2 at full width cut to one layer (384 experts of
  d_ff 2048, top-8; ``phase_serve_moe``: the prefill on ``tc_prefill``
  and the decode on ``split_decode`` at head dim 112, the MoE layer of
  the long prefill against the same call on the CPU in f32, the same
  dropped entries exactly) and mamba2-2.7b whole (``phase_serve_ssm``:
  64 Mamba2 layers, no kernel of the port on its path), each with its
  logits checked against a teacher-forced forward and planted faults;
* the mesh paths, emulated on a leading rank axis of one card: kimi-k2
  served on the production mesh (data 16 x model 16, the plans of
  ``launch.steps.plan_for_cell``; ``phase_serve_mesh``, with
  ``phase_serve_moe``'s weights: ``moe_sharded`` in both forms and
  ``decode_attention_sharded``, each checked against the CPU in f32, the
  unsharded path and the ``split_decode`` kernel, with planted faults,
  and the dispatch buckets through ``two_layer_all_to_all``), the
  two-layer gradient sync of every gemma2-9b training leaf on a (pod 2,
  ici 4) grid (``phase_collectives``) and a 4-stage GPipe pipeline of
  gemma2-9b blocks equal to sequential application bit for bit
  (``phase_pipeline``, its stages on ``tc_prefill``);
* serving of the vlm and audio families: llava-next-34b at full width
  and depth (60 layers, 68.78 GB of bf16 weights; ``phase_serve_vlm``:
  the same traffic with 576 image prefix rows before the long prompt,
  and an image-prefixed batch of 4 x (576 + 32) + 16, the prefill on
  ``tc_prefill`` and the decode on ``split_decode`` at 7 query heads a
  kv head; a decode after the prefix's KV rows were zeroed must fail
  its check) and whisper-tiny whole (``phase_serve_audio``: the
  reference CLI's generate on f32 frames against bf16 weights, so the
  encoder and the cross-attention run on ``tc_f32`` and the decoder's
  self-attention in bf16, and a 448-step decode on seeded frames; a
  causal encoder and a zeroed encoder output must fail their checks);
* serving from the training phase's newest checkpoint
  (``phase_serve_restore``): ``launch.serve.restore_params`` reads it
  through the planned collective read with the node cache and without,
  each restored state byte for byte the saved one, and ``generate``'s
  tokens equal to those of the state the training run ended with;
* the reference's executable checkers (``phase_checks``):
  ``repro_torch.testing.rounds_checks`` and ``spmd_checks`` on the card,
  every check passing under the CPU run's names, with the I/O kernels
  launched on their patterns (nested overlaps, domain spanners, seeded
  random extents, the swapped placement, 1 to 5 rounds);
* ``REPRO_PERF_OPTS=0`` (``phase_perf_opts``, and a generate of
  gemma2-9b in ``phase_serve``): each attention route's f32 p.v variant
  held to the plain version under the setting (f32 at relative L2 1e-4,
  bf16 by the share of bit-equal outputs), the default variant failing
  that check, each timed beside the default, its bound, the plain
  version and SDPA or ``flex_attention`` in f32; the backward's variant
  at the training shape; and a main-path training step of the training
  phase's model on ``tc_f32_pv32`` and the backward's variant;
* gemma2-9b's roofline cells (``phase_roofline``): ``train_4k`` (depth
  2, batch 1), ``prefill_32k`` (all 42 layers, batch 1) and
  ``decode_32k`` (42 layers, batch 4 against a seeded 32768-long cache)
  at full width in bf16, each step from ``launch.steps.input_specs`` on
  real tensors, timed, counted by ``launch.op_analysis`` (equal to the
  ``meta`` trace's FLOPs, which it requires) and set against the H100's
  roofline terms, with ``mfu`` and ``hfu``.

Every phase prints one JSON line; any failed check raises, and the run
exits non-zero. The line before the last lists every kernel with its
launches on the main paths, its time, its bound and the plain and library
times (``pack`` at its largest shape, in a training save, with its
host-path and drain-window cases beside; ``route_spans`` at stage 2's
buckets, with its other two widths beside; for attention with the
softcap, the library is
``flex_attention``, compiled by ``torch.compile`` with its caches under
``build/``); the last line is ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the repository's ``src/`` beside it, the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPS = 10                     # timed runs per kernel measurement
HOLD_CYCLES = 400_000         # about 0.2 ms of device clock: see time_ms
# attention: atol = rtol per element (f32: test_flash_kernel.py's; bf16:
# one bf16 ulp, 2^-7 relative) and a relative L2 distance for both
ATTN_TOL = {"bfloat16": 8e-3, "float32": 5e-3}
ATTN_REL_L2 = 1e-2
SERVE_REL_L2 = 5e-2           # bf16 logits, 42 layers: see phase_serve
LONG_PROMPT = 8192            # crosses gemma2's 4096 window
REPLACES = {
    "bitonic_sort": "src/repro/kernels/sort.py:72",
    "coalesce": "src/repro/kernels/coalesce_kernel.py:73",
    "fused_sort_pack": "src/repro/kernels/fused_round.py:64",
    "zero_skip_encode": "src/repro/kernels/fused_round.py:129",
    "zero_skip_decode": "src/repro/kernels/fused_round.py:172",
    "pack": "src/repro/kernels/pack.py:56",
    "flash_attention_fused": "src/repro/kernels/flash.py:92",
    "flash_attention_bwd": "XLA autodiff of models.layers.flash_attention "
                           "(no Pallas kernel)",
    "route_spans": "jnp element routing of src/repro/core/exchange.py "
                   "(repack_sorted, bucket_by_dest; no Pallas kernel)",
}
SOURCES = {
    "bitonic_sort": "src/repro_torch/kernels/csrc/sort.cu",
    "coalesce": "src/repro_torch/kernels/csrc/coalesce_kernel.cu",
    "fused_sort_pack": "src/repro_torch/kernels/csrc/fused_round.cu",
    "zero_skip_encode": "src/repro_torch/kernels/csrc/zero_skip.cu",
    "zero_skip_decode": "src/repro_torch/kernels/csrc/zero_skip.cu",
    "pack": "src/repro_torch/kernels/csrc/pack.cu",
    "flash_attention_fused": "src/repro_torch/kernels/csrc/flash.cu",
    "flash_attention_bwd": "src/repro_torch/kernels/csrc/flash_bwd.cu",
    "route_spans": "src/repro_torch/kernels/csrc/route_spans.cu",
}
TABLE = (   # every pallas_call of the reference, by def line
    ("fused_sort_pack", "src/repro/kernels/fused_round.py:64", "ported"),
    ("bitonic_sort", "src/repro/kernels/sort.py:72", "ported"),
    ("coalesce", "src/repro/kernels/coalesce_kernel.py:73", "ported"),
    ("zero_skip_encode", "src/repro/kernels/fused_round.py:129", "ported"),
    ("zero_skip_decode", "src/repro/kernels/fused_round.py:172", "ported"),
    ("pack", "src/repro/kernels/pack.py:56", "ported"),
    ("flash_attention_fused", "src/repro/kernels/flash.py:92", "ported"),
    ("flash_attention_bwd", REPLACES["flash_attention_bwd"],
     "new: no TPU counterpart (the gradient of the ported attention)"),
    ("route_spans", REPLACES["route_spans"],
     "new: no TPU counterpart (the round engine's element routing)"),
)
FLASH_SOURCES = ["src/repro_torch/kernels/csrc/flash.cu",
                 "src/repro_torch/kernels/csrc/flash_decode.cu",
                 "src/repro_torch/kernels/csrc/flash_tiles.cuh",
                 "src/repro_torch/kernels/csrc/flash_wgmma.cuh",
                 "src/repro_torch/kernels/csrc/flash_mma.cuh"]
NOTES = {"flash_attention_fused":
         "ports the semantics of the model's attention "
         "(src/repro/models/layers.py:112): at its default p and v rounded "
         "to bf16 for p.v, summed in f32, f32 inputs included; under "
         "REPRO_PERF_OPTS=0 each route's f32 p.v variant, the Pallas "
         "kernel's arithmetic (launches_pv32)"}


def sass_counts(nvcc: str, lib: Path) -> dict:
    """Machine instructions and tensor-core ``HMMA`` instructions of each
    hd-256 ``flash_tc_f32_kernel`` in ``lib`` (``cuobjdump -sass``, beside
    ``nvcc``), or the reason there are none."""
    try:
        out = subprocess.run(
            [str(Path(nvcc).with_name("cuobjdump")), "-sass", str(lib)],
            capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        return {"error": str(e)}
    counts = {}
    for fn in out.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        if "flash_tc_f32_kernel" not in name or "ILi256E" not in name:
            continue
        ops = re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", fn)
        counts[name] = {"instructions": len(ops),
                        "HMMA": sum(o.startswith("HMMA") for o in ops)}
    return counts


# The H100 SXM's data-sheet peaks, ``repro_torch.launch.mesh``'s, set once
# by ``load_peaks``: ``HBM_BW`` (device memory), ``PEAK_FLOPS_BF16`` /
# ``_TF32`` (dense tensor-core rates), ``PEAK_FLOPS_F32`` (float32 outside
# the tensor cores; no int32 row in the table, so the I/O kernels'
# compares are bounded at it)
HBM_BW = PEAK_FLOPS_BF16 = PEAK_FLOPS_TF32 = PEAK_FLOPS_F32 = None


def load_peaks() -> None:
    """Set the peaks above from ``repro_torch.launch.mesh`` (``src/`` on
    the path)."""
    global HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_TF32, PEAK_FLOPS_F32
    from repro_torch.launch import mesh
    HBM_BW, PEAK_FLOPS_F32 = mesh.HBM_BW, mesh.PEAK_FLOPS_F32
    PEAK_FLOPS_BF16, PEAK_FLOPS_TF32 = mesh.PEAK_FLOPS_BF16, \
        mesh.PEAK_FLOPS_TF32


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class CheckFailed(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def time_ms(torch, fn, reps: int, flush=None) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after two
    warm-up runs. Zeroing ``flush`` (larger than the 50 MB L2) before
    each run makes ``fn`` find its inputs in device memory, as the main
    path does. A device-side wait of ``HOLD_CYCLES`` before the first
    event keeps the card busy while the host enqueues ``fn``, so the
    events span the device's work and not the host's launch work (which
    outlasts a call of tens of microseconds)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BW * 1e3
    t_ops = ops / PEAK_FLOPS_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"shape/dtype {tuple(g.shape)} {g.dtype} vs "
                f"{tuple(w.shape)} {w.dtype}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                           .abs().max().item()))
    return err


# ---------------------------------------------------------------- inputs

def sort_inputs(torch, rows, n, live_frac, gen, dev):
    """Unsorted merged-list rows: a fraction live, duplicate keys, the
    rest PAD_OFFSET padding with zero length."""
    from repro_torch.core.requests import PAD_OFFSET
    live = torch.rand(rows, n, generator=gen, device=dev) < live_frac
    keys = torch.randint(0, 1 << 27, (rows, n), generator=gen, device=dev,
                         dtype=torch.int32)
    keys = torch.where(live, keys // 512 * 512, PAD_OFFSET)
    lens = torch.where(live, torch.randint(1, 513, (rows, n), generator=gen,
                                           device=dev, dtype=torch.int32), 0)
    carry = torch.randint(0, 1 << 30, (rows, n), generator=gen, device=dev,
                          dtype=torch.int32)
    return keys.to(torch.int32), lens.to(torch.int32), carry


def coalesce_inputs(torch, rows, n, live, gen, dev):
    """Offset-sorted BTIO-like rows: ``live`` requests of 512 elements,
    contiguous except at every 512th entry and at ~1% random gaps."""
    from repro_torch.core.requests import PAD_OFFSET
    idx = torch.arange(live, device=dev)
    gap = ((idx % 512 == 0) | (torch.rand(rows, live, generator=gen,
                                          device=dev) < 0.01)).to(torch.int64)
    offs = idx * 512 + torch.cumsum(gap, dim=1) * 4096
    off = torch.full((rows, n), PAD_OFFSET, dtype=torch.int32, device=dev)
    ln = torch.zeros((rows, n), dtype=torch.int32, device=dev)
    off[:, :live] = offs.to(torch.int32)
    ln[:, :live] = 512
    return off, ln


def drain_inputs(torch, rows, cap, live, out_len, dcap, gen, dev):
    """Unsorted drain lists: ``live`` disjoint requests per row tiling
    every other cut of the window (holes between), scattered over the
    ``cap`` slots among PAD_OFFSET padding, with payload slabs at
    distinct places of a ``[rows, dcap]`` buffer."""
    from repro_torch.core.requests import PAD_OFFSET
    step = out_len // (2 * live)
    cuts = (torch.arange(2 * live, device=dev) * step
            + torch.randint(0, step, (rows, 2 * live), generator=gen,
                            device=dev))
    cuts = torch.cat([cuts, torch.full((rows, 1), out_len, device=dev)], 1)
    offs = cuts[:, 0:-1:2]
    lens = cuts[:, 1::2] - offs
    base = torch.randint(0, 1 << 26, (rows,), generator=gen, device=dev)
    base = base // out_len * out_len
    starts = torch.cumsum(lens, 1) - lens
    slot = torch.argsort(torch.rand(rows, cap, generator=gen, device=dev), 1)
    off = torch.full((rows, cap), PAD_OFFSET, dtype=torch.int32, device=dev)
    ln = torch.zeros((rows, cap), dtype=torch.int32, device=dev)
    st = torch.zeros((rows, cap), dtype=torch.int32, device=dev)
    where = slot[:, :live]
    off.scatter_(1, where, (offs + base[:, None]).to(torch.int32))
    ln.scatter_(1, where, lens.to(torch.int32))
    st.scatter_(1, where, starts.to(torch.int32))
    data = torch.randint(-2**31, 2**31 - 1, (rows, dcap), generator=gen,
                         device=dev, dtype=torch.int32)
    covered = int(lens.sum().item())
    return off, ln, st, data, base.to(torch.int32), covered


def sparse_rows(torch, rows, n, gen, dev, dtype=None):
    """Nonzero rows in which half of the 8-element cells are zero (a
    sparse checkpoint page, the payload the rle codec exists for): int32
    by default; of another ``dtype`` small nonzero values, and for a
    float some -0.0 (a zero) and NaN (a nonzero) besides."""
    dtype = torch.int32 if dtype is None else dtype
    top = 2**31 - 1 if dtype == torch.int32 else 256
    x = torch.randint(1, top, (rows, n), generator=gen, device=dev,
                      dtype=torch.int32).to(dtype)
    keep = torch.rand(rows, n // 8, 1, generator=gen, device=dev) < 0.5
    x.view(rows, n // 8, 8).mul_(keep)
    if dtype.is_floating_point:
        x.view(rows, n // 8, 8)[:, ::7, 3] = -0.0
        x[:, 5::1001] = float("nan")
    return x


def sparse_cells(D, seed):
    """``D`` with half of its 8-element cells zeroed, chosen from
    ``seed`` (numpy)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    D = D.copy()
    cells = D.reshape(D.shape[0], -1, 8)
    cells[rng.random(cells.shape[:2]) < 0.5] = 0
    return D


# ---------------------------------------------------------------- phases

def phase_kernels(torch, dev, reps):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.core.requests import PAD_OFFSET
    from repro_torch.kernels import coalesce_kernel, fused_round, ref, sort
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results = {}
    flush = torch.empty(1 << 25, dtype=torch.int32, device=dev)  # 128 MiB

    def timed(fn, n=reps):
        return time_ms(torch, fn, n, flush)

    for rows, n in ((16, 32768), (1024, 8192)):
        o, ln, c = sort_inputs(torch, rows, n, 1 / 16, gen, dev)
        err = max_abs_err(torch, sort.bitonic_sort(o, ln, c),
                          ref.sort_ref(o, ln, c))
        require(err == 0, f"bitonic_sort [{rows}, {n}] != sort_ref")
        b, by = bound(6 * rows * n * 4, rows * n * math.log2(n))

        def library():   # the same function: keys and both carries
            keys, idx = torch.sort(o, dim=1, stable=True)
            return keys, ln.gather(1, idx), c.gather(1, idx)

        lib_err = max_abs_err(torch, library(), ref.sort_ref(o, ln, c))
        require(lib_err == 0, f"torch.sort + gathers [{rows}, {n}] "
                "!= sort_ref")
        rec = {"shape": [rows, n], "max_abs_err": err,
               "ms": timed(lambda: sort.bitonic_sort(o, ln, c)),
               "plain_ms": timed(lambda: ref.sort_ref(o, ln, c)),
               "library_ms": timed(library),
               "library": "torch.sort(stable=True) + two gathers",
               "bound_ms": b, "bound_by": by}
        emit({"phase": "kernel", "kernel": "bitonic_sort", **rec})
        results.setdefault("bitonic_sort", rec)

    # the rows whose int32 ends wrap, each alone and tiled over 8 tiles
    P = PAD_OFFSET
    wrap = torch.tensor([[0, 4, 2147483640, -2147483646, P, P, P, P],
                         [4, 4, 10, 3, 0, 0, 0, 0],
                         [0, 4, P, -2147483647, 100, P, P, P],
                         [4, 4, 2, 3, 4, 0, 0, 0],
                         [0, 4, P, -2147483647, P, P, P, P],
                         [4, 4, 2, 3, 0, 0, 0, 0]], dtype=torch.int32,
                        device=dev)
    wo, wl = wrap[0::2].contiguous(), wrap[1::2].contiguous()
    for o, ln in ((wo, wl), (wo.repeat(1, 4096), wl.repeat(1, 4096))):
        err = max_abs_err(torch, coalesce_kernel.coalesce(o, ln),
                          ref.coalesce_ref(o, ln))
        require(err == 0, f"coalesce wrap rows {list(o.shape)} "
                "!= coalesce_ref")
    rows, n = 16, 32768
    shapes = {}
    gen_live = torch.Generator(device=dev)     # keeps gen's later draws
    gen_live.manual_seed(1)
    for name, live, g in (("path", 2048, gen), ("all_live", n, gen_live)):
        o, ln = coalesce_inputs(torch, rows, n, live, g, dev)
        got = coalesce_kernel.coalesce(o, ln)
        err = max_abs_err(torch, got, ref.coalesce_ref(o, ln))
        require(err == 0, f"coalesce [16, 32768] {name} != coalesce_ref")
        b, by = bound((4 * rows * n + rows) * 4, rows * n * 4)
        shapes[name] = {"shape": [rows, n], "live": live,
                        "max_abs_err": err, "runs": int(got[2].sum().item()),
                        "ms": timed(lambda: coalesce_kernel.coalesce(o, ln)),
                        "plain_ms": timed(lambda: ref.coalesce_ref(o, ln)),
                        "bound_ms": b, "bound_by": by}
    rec = {**shapes["path"], "all_live": shapes["all_live"],
           "wrap_rows_equal": True, "library_ms": None,
           "max_active_clusters": coalesce_kernel.max_active_clusters(n)}
    emit({"phase": "kernel", "kernel": "coalesce", **rec})
    results["coalesce"] = rec

    # two-phase drain: 1024 ranks x 16 buckets of 512; TAM drain: 16
    # groups x 16 buckets of 1536 padded to 32768
    for rows, cap, live, dcap in ((1024, 8192, 2048, 16 * 131072),
                                  (16, 32768, 4096, 16 * 262144)):
        out_len = 262144
        o, ln, st, data, base, covered = drain_inputs(
            torch, rows, cap, live, out_len, dcap, gen, dev)
        got = fused_round.fused_sort_pack(o, ln, st, data, base, out_len)
        chunk = 32   # the plain version's temporaries grow with dcap

        def plain():
            outs = [ref.fused_sort_pack_ref(o[i:i + chunk], ln[i:i + chunk],
                                            st[i:i + chunk],
                                            data[i:i + chunk],
                                            base[i:i + chunk], out_len)
                    for i in range(0, rows, chunk)]
            return (torch.cat([w for w, _ in outs]),
                    torch.cat([m for _, m in outs]))

        err = max_abs_err(torch, got, plain())
        require(err == 0, f"fused_sort_pack [{rows}, {cap}] != plain")
        # the sort's compares, then one max a position (the walk)
        b, by = bound(3 * rows * cap * 4 + covered * 4
                      + 2 * rows * out_len * 4,
                      rows * cap * math.log2(cap) + rows * out_len)
        rec = {"shape": [rows, cap], "out_len": out_len, "dcap": dcap,
               "max_abs_err": err,
               "ms": timed(lambda: fused_round.fused_sort_pack(
                   o, ln, st, data, base, out_len)),
               "plain_ms": timed(plain, max(2, reps // 4)),
               "library_ms": None, "bound_ms": b, "bound_by": by}
        emit({"phase": "kernel", "kernel": "fused_sort_pack", **rec})
        results.setdefault("fused_sort_pack", rec)
        del o, ln, st, data, got
        torch.cuda.empty_cache()

    # the rle wire: two-phase write buckets [1024 ranks x 16, 131072],
    # TAM write buckets [16 groups x 16, 262144], a read's windows
    # [16, 262144], int32 as on the paths; then the read's shape at the
    # other widths (uint8, bfloat16, float64)
    for rows, n, dtype in ((16384, 131072, torch.int32),
                           (256, 262144, torch.int32),
                           (16, 262144, torch.int32),
                           (16, 262144, torch.uint8),
                           (16, 262144, torch.bfloat16),
                           (16, 262144, torch.float64)):
        for rec in zero_skip_case(torch, fused_round, ref, rows, n, dtype,
                                  gen, dev, timed, reps):
            results.setdefault(rec["kernel"], rec)
    del flush
    return results


def bits(torch, t):
    """``t`` viewed as the integers of its width (its bits)."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def zero_skip_case(torch, fused_round, ref, rows, n, dtype, gen, dev, timed,
                   reps):
    """Both zero-skip kernels at ``[rows, n]`` of ``dtype``, bit for bit
    against their plain versions and through a round trip, timed beside
    their width-aware bounds (w bytes an element): encode reads n
    elements and writes n values and n int32 positions, rows * n * (2w +
    4); decode reads pos whole and vals where pos >= 0 (the nonzeros) and
    writes the output once, rows * n * (4 + w) + nonzero * w."""
    x = sparse_rows(torch, rows, n, gen, dev, dtype)
    w = x.element_size()
    tag = f"[{rows}, {n}] {str(dtype).split('.')[-1]}"
    chunk = max(1, (1 << 27) // n)   # the plain versions' int64 temps
    spans = [slice(i, i + chunk) for i in range(0, rows, chunk)]
    vals, pos = fused_round.zero_skip_encode(x)
    err_e = max(max_abs_err(torch, (bits(torch, vals[c]), pos[c]),
                            (bits(torch, v), p))
                for c in spans
                for v, p in (ref.zero_skip_encode_ref(x[c]),))
    require(err_e == 0, f"zero_skip_encode {tag} != plain")
    nonzero = int(ref.zero_skip_nonzero(x).sum().item())
    b, by = bound(rows * n * (2 * w + 4), 2 * rows * n)
    base = {"shape": [rows, n], "dtype": str(dtype).split(".")[-1],
            "nonzero": nonzero}
    enc = {"kernel": "zero_skip_encode", **base, "max_abs_err": err_e,
           "chunks": fused_round.encode_chunks(
               rows, n, torch.cuda.get_device_properties(dev)
               .multi_processor_count),
           "ms": timed(lambda: fused_round.zero_skip_encode(x)),
           "plain_ms": timed(lambda: [ref.zero_skip_encode_ref(x[c])
                                      for c in spans], max(2, reps // 4)),
           "library_ms": None, "bound_ms": b, "bound_by": by}
    emit({"phase": "kernel", **enc})

    out = fused_round.zero_skip_decode(vals, pos)
    want = torch.where(ref.zero_skip_nonzero(x), bits(torch, x), 0)
    require(torch.equal(bits(torch, out), want),
            f"zero_skip {tag} round trip")
    del x, want
    err_d = max(max_abs_err(torch, (bits(torch, out[c]),),
                            (bits(torch, ref.zero_skip_decode_ref(
                                vals[c], pos[c])),))
                for c in spans)
    require(err_d == 0, f"zero_skip_decode {tag} != plain")
    del out
    torch.cuda.empty_cache()
    b, by = bound(rows * n * (4 + w) + nonzero * w, rows * n)
    dec = {"kernel": "zero_skip_decode", **base, "max_abs_err": err_d,
           "ms": timed(lambda: fused_round.zero_skip_decode(vals, pos)),
           "plain_ms": timed(lambda: [ref.zero_skip_decode_ref(
               vals[c], pos[c]) for c in spans], max(2, reps // 4)),
           "bound_ms": b, "bound_by": by}
    # library: one scatter_ into a zeroed [rows, n + 1] buffer whose last
    # column takes pos -1, the index built inside the timing
    stage = torch.empty((rows, n + 1), dtype=vals.dtype, device=dev)
    dec["library_ms"] = timed(lambda: bits(torch, stage).zero_().scatter_(
        1, torch.where(pos >= 0, pos, n).to(torch.int64), bits(torch, vals)))
    dec["library"] = "torch.where + scatter_ into [rows, n + 1]"
    emit({"phase": "kernel", **dec})
    del vals, pos, stage
    torch.cuda.empty_cache()
    return enc, dec


def attn_err(got, want, tol: float, rel_l2: float = ATTN_REL_L2) -> dict:
    """Max |got - want|, the relative L2 distance, the scale of ``want``
    (its root mean square), and whether both limits hold: every element
    within atol = rtol = ``tol`` and the distance within ``rel_l2``."""
    g, w = got.float(), want.float()
    require(g.shape == w.shape and got.dtype == want.dtype,
            f"{tuple(got.shape)} {got.dtype} vs "
            f"{tuple(want.shape)} {want.dtype}")
    err = (g - w).abs()
    rel = float((g - w).norm() / w.norm())
    return {"max_abs_err": float(err.max()), "rel_l2": rel,
            "rms_want": float(w.pow(2).mean().sqrt()),
            "within": bool((err <= tol + tol * w.abs()).all())
            and rel <= rel_l2}


def attention_bound(torch, q_shape, k_shape, itemsize, causal, window,
                    q_offset, kv_len, pv32=False):
    """``(bound_ms, bound_by, pairs, keys)`` of one attention call: the
    FLOPs of the unmasked pairs (two products of hd) at the dense
    tensor-core rate of their operands' type, and the bytes of q, out
    and the keys and values some query sees at the memory rate. bf16
    runs both products at the bf16 rate; f32 runs q.k at the TF32 rate
    and p.v, whose p and v the function rounds to bf16, at the bf16
    rate; the f32 p.v variant (``pv32``) runs p.v, an f32 product, at
    the TF32 rate."""
    b, sq, hq, hd = q_shape
    skv, hkv = k_shape[1], k_shape[2]
    from repro_torch.launch.op_analysis import attention_work
    pairs, keys = attention_work(b, sq, hq, skv, causal, window, q_offset,
                                 kv_len)
    qk_peak = PEAK_FLOPS_BF16 if itemsize == 2 else PEAK_FLOPS_TF32
    pv_peak = PEAK_FLOPS_TF32 if pv32 else PEAK_FLOPS_BF16
    t_ops = (2 * hd * pairs / qk_peak + 2 * hd * pairs / pv_peak) * 1e3
    t_bytes = (2 * b * sq * hq * hd + 2 * b * keys * hkv * hd) \
        * itemsize / HBM_BW * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", pairs, keys)


# (name, b, sq, skv, causal, window, q_offset, kv_len, cap): gemma2-9b's
# attention (16 query heads over 8 kv heads of 256, softcap 50; other
# heads in FLASH_HEADS) at the serve phase's shapes: a global and a local prefill layer of 8192
# tokens, a decode layer at the last of 16 steps after that prefill
# (cache 8192 + 16) at batch 4 (local) and at batch 1 (global: 672 of
# the serve phase's launches), an odd shape that needs padding on both
# axes, the global prefill without the softcap (the attention of
# qwen1.5, yi and glm4), where F.scaled_dot_product_attention computes
# the same function, the training phase's global layer (batch 1 x 4096
# tokens: in f32 the shape of every forward launch of phase_train), and
# kimi-k2's attention (64 query heads over 8 kv heads of 112, no softcap
# or window) at phase_serve_moe's shapes: its 8192 prefill (where SDPA
# computes the same function) and a decode step at batch 1 against the
# 8208 cache; llava-next-34b's (56 query heads over 8 kv heads of 128:
# g = 7) at phase_serve_vlm's: the long prompt's 576 + 8192 prefill, the
# image request's batch-4 576 + 32 prefill, a decode step at batch 1
# against the 8784 cache; and whisper-tiny's (6 heads of 64, g = 1) at
# phase_serve_audio's: the encoder over 1500 frames (non-causal, f32 on
# the path), the decoder's self-attention at batch 4 (the 32-token
# prefill, a decode step against the 48 cache) and its cross-attention
# (non-causal, 32 queries and 1 against the 1500 encoder rows; f32 on the
# path)
FLASH_CASES = (
    ("prefill_global", 1, 8192, 8192, True, None, 0, None, 50.0),
    ("prefill_window", 1, 8192, 8192, True, 4096, 0, None, 50.0),
    ("decode", 4, 1, 8208, False, 4096, 8207, 8208, 50.0),
    ("decode_global_b1", 1, 1, 8208, False, None, 8207, 8208, 50.0),
    ("odd_padded", 1, 1000, 1300, True, 4096, 300, None, 50.0),
    ("prefill_global_nocap", 1, 8192, 8192, True, None, 0, None, None),
    ("train_global", 1, 4096, 4096, True, None, 0, None, 50.0),
    ("kimi_prefill", 1, 8192, 8192, True, None, 0, None, None),
    ("kimi_decode_b1", 1, 1, 8208, False, None, 8207, 8208, None),
    ("llava_prefill", 1, 8768, 8768, True, None, 0, None, None),
    ("llava_image_prefill", 4, 608, 608, True, None, 0, None, None),
    ("llava_decode_b1", 1, 1, 8784, False, None, 8783, 8784, None),
    ("whisper_encoder", 4, 1500, 1500, False, None, 0, None, None),
    ("whisper_self_prefill", 4, 32, 32, True, None, 0, None, None),
    ("whisper_self_decode", 4, 1, 48, False, None, 47, 48, None),
    ("whisper_xattn_prefill", 4, 32, 1500, False, None, 0, None, None),
    ("whisper_xattn_decode", 4, 1, 1500, False, None, 0, None, None),
)
FLASH_HEADS = {"kimi_prefill": (64, 8, 112), "kimi_decode_b1": (64, 8, 112),
               **{c: (56, 8, 128) for c in ("llava_prefill",
                                            "llava_image_prefill",
                                            "llava_decode_b1")},
               **{c[0]: (6, 6, 64) for c in FLASH_CASES
                  if c[0].startswith("whisper")}}
# the cases of the vlm and audio paths, and the type each runs in there
VLM_AUDIO_CASES = {"llava_prefill": "bfloat16",
                   "llava_image_prefill": "bfloat16",
                   "llava_decode_b1": "bfloat16",
                   "whisper_encoder": "float32",
                   "whisper_self_prefill": "bfloat16",
                   "whisper_self_decode": "bfloat16",
                   "whisper_xattn_prefill": "float32",
                   "whisper_xattn_decode": "float32"}
# products of hd a visible pair the f32 route issues: q.k as three TF32
# products (the split), p.v as one bf16 product
F32_PRODUCTS = {"tf32": 3, "bf16": 1}


def _sdpa_no_softcap(torch, q, k, v, causal, window, q_offset, kv_len):
    """``F.scaled_dot_product_attention`` on the same shapes and masks
    but WITHOUT the softcap: a yardstick, not the same function."""
    import torch.nn.functional as F
    sq, skv = q.shape[1], k.shape[1]
    kv_len = skv if kv_len is None else kv_len
    qp = torch.arange(sq, device=q.device)[:, None] + q_offset
    kp = torch.arange(kv_len, device=q.device)[None, :]
    mask = torch.ones((sq, kv_len), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= qp - kp < window
    qt = q.transpose(1, 2)
    kt, vt = (x[:, :kv_len].transpose(1, 2) for x in (k, v))
    if causal and window is None and q_offset == 0 and sq == kv_len:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


FLEX = ("torch.nn.attention.flex_attention.flex_attention (torch.compile; "
        "score_mod: the softcap; block mask: causal, window, kv_len; "
        "enable_gqa)")
F32_LIBRARY = ("none (f32: the kernel rounds p and v to bf16 for p.v; SDPA "
               "and flex_attention keep them in f32)")


def _flex_same_fn(torch, q, k, v, causal, window, q_offset, kv_len, cap):
    """``flex_attention`` on the same inputs, compiled: the same function
    as the kernel. A ``score_mod`` applies the softcap to the scaled
    logit and a block mask the causal, window and kv_len masks; on bf16
    inputs its kernel rounds p to bf16 for p.v and sums l from the
    unrounded p, as the kernel does. Each call compiles afresh for
    static shapes: dynamo would compile a recompile (a new shape or
    type) for dynamic shapes, whose kernel is slower (on an H100 at the
    f32 training shape, 187 ms against 39). Timed and checked here only;
    the port never calls it. Returns a function giving
    ``[B, Sq, Hq, hd]``."""
    import torch._dynamo
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                    flex_attention)
    sq, skv, hd = q.shape[1], k.shape[1], q.shape[3]
    kv_len = skv if kv_len is None else kv_len

    def mask_mod(b, h, qi, ki):
        qp = qi + q_offset
        ok = ki < kv_len
        if causal:
            ok = ok & (ki <= qp)
        if window is not None:
            ok = ok & (qp - ki < window)
        return ok

    def softcap(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    block_mask = create_block_mask(mask_mod, None, None, sq, skv,
                                   device=q.device)
    torch._dynamo.reset()
    fn = torch.compile(flex_attention, dynamic=False)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: fn(qt, kt, vt, score_mod=None if cap is None else softcap,
                      block_mask=block_mask, scale=1.0 / math.sqrt(hd),
                      enable_gqa=True).transpose(1, 2)


def flex_library(torch, q, k, v, kw, want, tol, reps, flush) -> dict:
    """``library_ms`` of a bf16 softcap case: compiled ``flex_attention``
    held to the plain version at the kernel's limits and timed. Its time
    is the case's ``library_ms`` only where it passes that check; where
    it does not compile or disagrees the reason is kept and
    ``library_ms`` is null."""
    try:
        fn = _flex_same_fn(torch, q, k, v, kw["causal"], kw["window"],
                           kw["q_offset"], kw["kv_len"], kw["logit_cap"])
        check = attn_err(fn(), want, tol)
        ms = time_ms(torch, fn, reps, flush)
    except Exception as exc:   # a measurement of the library, not the port
        return {"library_ms": None,
                "library": f"{FLEX}: failed: {type(exc).__name__}: "
                           f"{str(exc)[:300]}"}
    rec = {"flex_ms": ms, "flex_max_abs_err": check["max_abs_err"],
           "flex_rel_l2": check["rel_l2"]}
    if check["within"]:
        return {**rec, "library_ms": ms, "library": FLEX}
    return {**rec, "library_ms": None,
            "library": f"{FLEX}: outside the kernel's limits"}


def planted_faults(ops, q, k, v, got, kw):
    """Wrong attentions at this case's shapes, which the check must
    fail: the kernel's output halved, and the kernel run with a mask
    dropped (the window, the causal mask) or with its keys cut short by
    one 64-key tile (a non-causal call without ``kv_len``: its keys
    bounded one tile short of Skv)."""
    faults = {"halved": lambda: got * 0.5}
    if kw.get("window") is not None and \
            kw["q_offset"] + q.shape[1] > kw["window"]:
        faults["window_dropped"] = lambda: ops.fused_attention(
            q, k, v, **{**kw, "window": None})
    if kw["causal"]:
        faults["causal_dropped"] = lambda: ops.fused_attention(
            q, k, v, **{**kw, "causal": False})
    if kw.get("kv_len") is not None:
        faults["kv_len_short_one_tile"] = lambda: ops.fused_attention(
            q, k, v, **{**kw, "kv_len": max(1, kw["kv_len"] - 64)})
    elif not kw["causal"] and k.shape[1] > 64:
        faults["keys_short_one_tile"] = lambda: ops.fused_attention(
            q, k, v, **{**kw, "kv_len": k.shape[1] - 64})
    return faults   # a mask that masks nothing here plants no fault


def phase_flash(torch, dev, reps):
    """``flash_attention_fused`` against ``flash_attention_ref`` on the
    card, bf16 and f32, at the serve phase's shapes and the training
    phase's, through ``ops.fused_attention`` as the model calls it; each
    line names the route the call launched (``flash._route``, checked
    against ``launches_by_route``). Each case also holds planted faults
    to the same limit and requires that they fail it. ``library_ms`` is
    the same function's: SDPA for the bf16 case without the softcap,
    compiled ``flex_attention`` for the bf16 softcap cases, none for f32
    (both libraries keep p.v in f32). f32 lines add the products the
    ``tc_f32`` route issues and their rate (``issued_tflops``). Returns
    the bf16 global prefill's line, with the case without the softcap
    (kernel and SDPA), kimi-k2's, llava-next-34b's and whisper-tiny's
    cases (each in the type its path runs) and the f32 lines of the 8192
    prefill and the training shape beside it."""
    from repro_torch.kernels import flash, ops, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    flush = torch.empty(1 << 25, dtype=torch.int32, device=dev)
    recs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        tol = ATTN_TOL[dname]
        for (name, b, sq, skv, causal, window, q_offset, kv_len,
             cap) in FLASH_CASES:
            hq, hkv, hd = FLASH_HEADS.get(name, (16, 8, 256))
            q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
                       for s in ((b, sq, hq, hd), (b, skv, hkv, hd),
                                 (b, skv, hkv, hd)))
            kw = dict(causal=causal, window=window, logit_cap=cap,
                      q_offset=q_offset, kv_len=kv_len)
            route = flash._route(b, sq, hq, hkv, hd, dtype)
            by_route = dict(flash.flash_attention_fused.launches_by_route)
            got = ops.fused_attention(q, k, v, **kw)
            by_route[route] += 1
            require(flash.flash_attention_fused.launches_by_route
                    == by_route, f"flash {name} {dname}: launched "
                    f"{flash.flash_attention_fused.launches_by_route}, "
                    f"not one {route}")
            want = ref.flash_attention_ref(q, k, v, **kw)
            check = attn_err(got, want, tol)
            planted = {}
            for fault, fn in planted_faults(ops, q, k, v, got, kw).items():
                planted[fault] = attn_err(fn(), want, tol)
            del got
            lib = {"library_ms": None, "library": F32_LIBRARY}
            if dtype == torch.bfloat16 and cap is not None:
                lib = flex_library(torch, q, k, v, kw, want, tol, reps,
                                   flush)
            del want
            kv_eff = skv if kv_len is None else kv_len
            bound_ms, bound_by, pairs, keys = attention_bound(
                torch, q.shape, k.shape, q.element_size(), causal, window,
                q_offset, kv_len)
            # SDPA's same function: no softcap, and bf16 (in f32 it keeps
            # p.v in f32; the kernel rounds to bf16); its masks causal or
            # explicit (_sdpa_no_softcap)
            same_fn = cap is None and dtype == torch.bfloat16
            sdpa_ms = time_ms(torch, _sdpa_no_softcap(
                torch, q, k, v, causal, window, q_offset, kv_len), reps,
                flush)
            if same_fn:
                lib = {"library_ms": sdpa_ms,
                       "library": "F.scaled_dot_product_attention "
                                  "(enable_gqa=True; is_causal=True or "
                                  "an explicit mask)"}
            rec = {"case": name, "dtype": dname, "route": route,
                   "q": list(q.shape),
                   "kv": list(k.shape), "causal": causal, "window": window,
                   "q_offset": q_offset, "kv_len": kv_eff,
                   "logit_cap": cap, "max_abs_err": check["max_abs_err"],
                   "rel_l2": check["rel_l2"], "rms_want": check["rms_want"],
                   "tol": tol, "tol_rel_l2": ATTN_REL_L2,
                   "planted_rel_l2": {f: c["rel_l2"]
                                      for f, c in planted.items()},
                   "planted_max_abs_err": {f: c["max_abs_err"]
                                           for f, c in planted.items()},
                   "pv": "bf16 p and v, f32 sum (the model attention's "
                         "default; the Pallas kernel keeps p.v in f32)",
                   "pairs": pairs, "keys_read": keys,
                   "ms": time_ms(torch, lambda: ops.fused_attention(
                       q, k, v, **kw), reps, flush),
                   "plain_ms": time_ms(
                       torch, lambda: ref.flash_attention_ref(q, k, v, **kw),
                       max(2, reps // 4), flush),
                   "bound_ms": bound_ms, "bound_by": bound_by, **lib,
                   "sdpa_ms_no_softcap": sdpa_ms,
                   "sdpa_note": "F.scaled_dot_product_attention without "
                                "the softcap" + ("" if same_fn else
                                                 ": not the same function")}
            rec["achieved_tflops"] = 4 * hd * pairs / rec["ms"] / 1e9
            if dtype == torch.float32:
                rec["products_issued"] = F32_PRODUCTS
                rec["issued_tflops"] = (2 * sum(F32_PRODUCTS.values()) * hd
                                        * pairs / rec["ms"] / 1e9)
            emit({"phase": "kernel", "kernel": "flash_attention_fused",
                  **rec})
            require(check["within"], f"flash {name} {dname}: {check}")
            for fault, c in planted.items():
                require(not c["within"], f"flash {name} {dname}: the "
                        f"planted fault {fault} passes the check: {c}")
            recs[name, dname] = rec
            del q, k, v
            torch.cuda.empty_cache()
    del flush
    nocap = recs["prefill_global_nocap", "bfloat16"]
    return {**recs["prefill_global", "bfloat16"],
            "nocap_case": {k: nocap[k] for k in (
                "case", "ms", "bound_ms", "library_ms", "library")},
            "kimi_cases": [{k: recs[c, "bfloat16"][k] for k in (
                "case", "route", "q", "kv", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library", "max_abs_err")}
                for c in ("kimi_prefill", "kimi_decode_b1")
                if (c, "bfloat16") in recs],
            "vlm_audio_cases": [{k: recs[c, d][k] for k in (
                "case", "dtype", "route", "q", "kv", "causal", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms", "library",
                "max_abs_err", "rel_l2")}
                for c, d in VLM_AUDIO_CASES.items() if (c, d) in recs],
            "f32_cases": [{k: recs[c, "float32"][k] for k in (
                "case", "route", "ms", "plain_ms", "bound_ms",
                "max_abs_err", "achieved_tflops", "issued_tflops")}
                for c in ("prefill_global", "train_global")
                if (c, "float32") in recs]}


def phase_pack(torch, dev, reps):
    """``ops.pack`` against ``ref.pack_ref`` on the card, exact, at a
    drain window's shape: 32768 request slots (24576 live, sorted,
    disjoint, holes between) packed into a 262144-element window."""
    from repro_torch.core.requests import PAD_OFFSET, RequestList
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    flush = torch.empty(1 << 25, dtype=torch.int32, device=dev)
    cap, live, out_len, base = 32768, 24576, 262144, 64 * 262144
    step = out_len // (2 * live)
    cuts = (torch.arange(2 * live, device=dev) * step
            + torch.randint(0, step, (2 * live,), generator=gen, device=dev))
    cuts = torch.cat([cuts, torch.full((1,), out_len, device=dev)])
    offs, lens = cuts[0:-1:2], cuts[1::2] - cuts[0:-1:2]
    off = torch.full((cap,), PAD_OFFSET, dtype=torch.int32, device=dev)
    ln = torch.zeros((cap,), dtype=torch.int32, device=dev)
    st = torch.zeros((cap,), dtype=torch.int32, device=dev)
    off[:live] = (offs + base).to(torch.int32)
    ln[:live] = lens.to(torch.int32)
    st[:live] = (torch.cumsum(lens, 0) - lens).to(torch.int32)
    covered = int(lens.sum().item())
    data = torch.randint(-2**31, 2**31 - 1, (covered,), generator=gen,
                         device=dev, dtype=torch.int32)
    r = RequestList(off, ln, torch.tensor(live, device=dev))
    got = ops.pack(r, st, data, base, out_len)
    want = ref.pack_ref(off, ln, st, data, base, out_len)
    err = max_abs_err(torch, (got,), (want,))
    require(err == 0, "pack [32768] -> [262144] != pack_ref")
    b, by = bound(3 * cap * 4 + covered * 4 + out_len * 4,
                  out_len * math.log2(cap))
    rec = {"shape": [cap], "live": live, "out_len": out_len,
           "covered": covered, "max_abs_err": err,
           "ms": time_ms(torch, lambda: ops.pack(r, st, data, base, out_len),
                         reps, flush),
           "plain_ms": time_ms(torch, lambda: ref.pack_ref(
               off, ln, st, data, base, out_len), reps, flush),
           "library_ms": None, "bound_ms": b, "bound_by": by}
    emit({"phase": "kernel", "kernel": "pack", **rec})
    del flush
    return rec


def phase_route_spans(torch, dev, reps):
    """``ops.route_spans`` at the TAM write's three routing widths, on the
    spans of one write of ``portbench``'s ``btio.tam.write`` cell (NPB
    BT-IO class D over 16 x 64 ranks, f64): the first call of each of the
    round engine's span copies is recorded, each rank's window
    (``repack_sorted``, [1024, 332760]), stage 1's repack ([16,
    21296640]) and stage 2's buckets ([16, 21296640] into [16, 16 x
    2122416]). On each call's spans the kernel must equal its plain
    version (``ref.route_spans_ref``) bit for bit, and the span path
    (span list and kernel) the torch body it replaces on the card.
    ``ms`` is the kernel, ``path_ms`` the span path, ``plain_ms`` the
    plain version, ``torch_ms`` the torch body; ``bound_ms`` the bytes
    the call must move (its spans, each covered payload element read
    once, every output element written once). Returns the buckets' case,
    the largest, with the others under ``cases``."""
    from portbench import harness
    from repro_torch.core import exchange as ex
    from repro_torch.kernels import ops, ref
    free_device(torch, dev)
    t0 = time.perf_counter()
    spec = harness.load_spec(ROOT, "btio.tam.write")
    O, L, C, D, file_len = harness.make_inputs(spec.config, 2147483659, dev)
    write = harness.make_collective(spec.config, spec.traffic, O, D,
                                    file_len, dev)
    calls, spans = {}, {}        # the first call of each kind, by rows
    saved = (ex._repack_sorted_spans, ex._route_elements_spans,
             ops.route_spans)

    def repack(r, starts, data, out_cap):
        calls.setdefault(("repack", data.shape[0]),
                         (r, starts, data, out_cap))
        return saved[0](r, starts, data, out_cap)

    def bucket(*a):
        calls.setdefault(("bucket", a[5].shape[0]), a)
        return saved[1](*a)

    def route(off, n, src, data, out_len):
        spans.setdefault((off.shape[0], out_len), (off, n, src, data))
        return saved[2](off, n, src, data, out_len)

    ex._repack_sorted_spans, ex._route_elements_spans = repack, bucket
    ops.route_spans = route
    try:
        write(O, L, C, D)
    finally:
        (ex._repack_sorted_spans, ex._route_elements_spans,
         ops.route_spans) = saved
    del write, O, L, C, D
    torch.cuda.synchronize()
    nodes = spec.config["nodes"]
    names = {("repack", nodes * spec.config["ranks_per_node"]):
             "route: each rank's window",
             ("repack", nodes): "intranode: stage 1's repack",
             ("bucket", nodes): "bucket: stage 2's buckets"}
    require(sorted(calls) == sorted(names),
            f"route_spans: recorded calls {sorted(calls)}")
    cases = []
    for key in sorted(calls):
        a = calls.pop(key)
        if key[0] == "repack":
            rows, out_len = a[2].shape[0], a[3]

            def path():
                return ex._repack_sorted_spans(*a)

            def body():
                return ex._repack_sorted_torch(*a)
        else:
            rows, out_len = a[5].shape[0], a[6] * a[7]

            def path():
                return ex._route_elements_spans(*a)[0]

            def body():
                return ex._route_elements_torch(*a)[0]
        off, n, src, data = spans[(rows, out_len)]
        got = bits(torch, ops.route_spans(off, n, src, data, out_len))
        plain_bad = int((got != bits(torch, ref.route_spans_ref(
            off, n, src, data, out_len))).sum().item())
        torch.cuda.empty_cache()
        body_bad = int((bits(torch, path()).reshape(got.shape)
                        != bits(torch, body()).reshape(got.shape))
                       .sum().item())
        del got
        torch.cuda.empty_cache()
        require(plain_bad == 0 == body_bad,
                f"route_spans {names[key]}: {plain_bad} elements differ "
                f"from route_spans_ref, {body_bad} from the torch body")
        item = data.element_size()
        b, by = bound(3 * off.numel() * 4
                      + int(n.sum(dtype=torch.int64).item()) * item
                      + rows * out_len * item, 0)
        rec = {"call": names[key], "shape": [rows, data.shape[-1]],
               "out_len": out_len, "dtype": str(data.dtype).split(".")[-1],
               "max_abs_err": 0,
               "ms": time_ms(torch, lambda: ops.route_spans(
                   off, n, src, data, out_len), reps),
               "path_ms": time_ms(torch, path, reps),
               "plain_ms": time_ms(torch, lambda: ref.route_spans_ref(
                   off, n, src, data, out_len), 3),
               "bound_ms": b, "bound_by": by, "library_ms": None}
        torch.cuda.empty_cache()
        rec["torch_ms"] = time_ms(torch, body, 3)
        del a, path, body
        torch.cuda.empty_cache()
        emit({"phase": "kernel", "kernel": "route_spans", **rec})
        cases.append(rec)
    del spans
    free_device(torch, dev)
    emit({"phase": "route_spans", "seconds": time.perf_counter() - t0})
    return {**cases[0], "cases": cases}


def phase_small(torch, dev):
    """A small BTIO write on the card equals the same write on the CPU:
    file bytes and every stats key, both methods, fused and unfused."""
    from repro_torch.core import (IOConfig, RankMesh, contiguous_layout,
                                  make_tam_write, make_twophase_write,
                                  write_reference)
    from repro_torch.io_patterns.generators import btio_write_pattern
    O, L, C, D = btio_write_pattern(16, 64, 4, 8, seed=1)
    mesh = RankMesh(4, 1, 4)
    layout = contiguous_layout(4 * 64 * 64 * 8, 4)
    ref = write_reference(layout, O, L, C, D)
    n = 0
    for fusion in (None, "fused_round"):
        cfg = IOConfig(req_cap=O.shape[1], data_cap=D.shape[1],
                       coalesce_cap=64, cb_buffer_size=4096,
                       kernel_fusion=fusion)
        for name, mk in (("twophase", make_twophase_write),
                         ("tam", make_tam_write)):
            kw = {"use_kernels": True} if name == "tam" else {}
            f_gpu, s_gpu = mk(mesh, layout, cfg, device=dev, **kw)(O, L, C, D)
            f_cpu, s_cpu = mk(mesh, layout, cfg, device="cpu",
                              **kw)(O, L, C, D)
            got = f_gpu.cpu().numpy().reshape(-1)
            require(got.tobytes() == ref.tobytes(),
                    f"small {name}/{fusion}: file != write_reference")
            require(got.tobytes() == f_cpu.numpy().reshape(-1).tobytes(),
                    f"small {name}/{fusion}: card != cpu")
            for k in s_cpu:
                require(s_gpu[k].cpu().tolist() == s_cpu[k].tolist(),
                        f"small {name}/{fusion}: stats {k} card != cpu")
            n += 1
    emit({"phase": "small_vs_cpu", "writes": n, "ok": True})


EF_BAND = 5e-2   # the CPU tests' relative band for ef-int8


def phase_small_codecs(torch, dev):
    """Small BTIO writes with the rle and ef-int8 codecs (ef-int8 on a
    float32 payload) and reads with and without rle, fused and unfused,
    both methods: the card equals the CPU — bytes and every stats key
    for rle and the reads, within one int8 step of the largest scale
    (and the 5e-2 band against ``write_reference``) for ef-int8; then
    the fused rle writes and reads of ``narrow_rle``."""
    import numpy as np

    from repro_torch.core import (IOConfig, RankMesh, contiguous_layout,
                                  make_tam_read, make_tam_write,
                                  make_twophase_read, make_twophase_write,
                                  write_reference)
    from repro_torch.io_patterns.generators import btio_write_pattern
    O, L, C, D = btio_write_pattern(16, 64, 4, 8, seed=2)
    D = sparse_cells(D, 2)
    payloads = {"rle": D,
                "ef-int8": D.astype(np.float32) / np.float32(1 << 20)}
    mesh = RankMesh(4, 1, 4)
    layout = contiguous_layout(4 * 64 * 64 * 8, 4)
    counts = {"writes": 0, "reads": 0}
    for fusion in (None, "fused_round"):
        for codec, P in payloads.items():
            ref = write_reference(layout, O, L, C, P)
            cfg = IOConfig(req_cap=O.shape[1], data_cap=P.shape[1],
                           coalesce_cap=64, cb_buffer_size=4096,
                           pipeline=True, pipeline_depth=2,
                           kernel_fusion=fusion, slow_hop_codec=codec)
            for name, mk, kw in (("twophase", make_twophase_write, {}),
                                 ("tam", make_tam_write,
                                  {"use_kernels": True})):
                tag = f"small {name}/{codec}/{fusion}"
                f_gpu, s_gpu = mk(mesh, layout, cfg, device=dev,
                                  **kw)(O, L, C, P)
                f_cpu, s_cpu = mk(mesh, layout, cfg, device="cpu",
                                  **kw)(O, L, C, P)
                got = f_gpu.cpu().numpy().reshape(-1)
                want = f_cpu.numpy().reshape(-1)
                if codec == "rle":
                    require(got.tobytes() == ref.tobytes() == want.tobytes(),
                            f"{tag}: file != write_reference / cpu")
                else:
                    step = np.abs(want).max() / 127
                    require(np.abs(got - want).max() <= step,
                            f"{tag}: card vs cpu beyond one int8 step")
                    require(np.abs(got - ref).max()
                            < EF_BAND * np.abs(ref).max(),
                            f"{tag}: outside the ef-int8 band")
                for k in s_cpu:
                    require(s_gpu[k].cpu().tolist() == s_cpu[k].tolist(),
                            f"{tag}: stats {k} card != cpu")
                counts["writes"] += 1
        ref = write_reference(layout, O, L, C, D)
        file = torch.as_tensor(ref).reshape(4, -1)
        for codec in (None, "rle"):
            cfg = IOConfig(req_cap=O.shape[1], data_cap=D.shape[1],
                           cb_buffer_size=4096, pipeline=True,
                           pipeline_depth=2, kernel_fusion=fusion,
                           slow_hop_codec=codec)
            for name, mk in (("twophase", make_twophase_read),
                             ("tam", make_tam_read)):
                got = mk(mesh, layout, cfg, device=dev)(O, L, C,
                                                        file).cpu()
                want = mk(mesh, layout, cfg, device="cpu")(O, L, C, file)
                require(torch.equal(got, want),
                        f"small read {name}/{codec}/{fusion}: card != cpu")
                for p in range(D.shape[0]):
                    n = int(L[p].sum())
                    require(np.array_equal(got[p, :n].numpy(), D[p, :n]),
                            f"small read {name}/{codec}/{fusion}: rank {p}")
                counts["reads"] += 1
    counts.update(narrow_rle(torch, dev, O, L, C, D, mesh, layout))
    emit({"phase": "small_codecs_vs_cpu", **counts, "ok": True})


def raw(torch, t) -> bytes:
    """The bytes of ``t``, in order."""
    return t.detach().cpu().contiguous().view(-1).view(
        torch.uint8).numpy().tobytes()


def narrow_rle(torch, dev, O, L, C, D, mesh, layout):
    """Fused rle writes and reads of 2- and 1-byte payloads (bfloat16 and
    uint8 cells of ``D``, zero where ``D`` is): every write's file equals
    ``write_reference`` (on the payload's bits) and the CPU run byte for
    byte, with equal stats; every read of that file returns each rank's
    payload, equal to the CPU read; the zero-skip kernels ran."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import (IOConfig, make_tam_read, make_tam_write,
                                  make_twophase_read, make_twophase_write,
                                  write_reference)
    bf = torch.from_numpy(D).to(torch.float32).to(torch.bfloat16)
    u8 = torch.from_numpy(np.where(D == 0, 0, D % 255 + 1).astype(np.uint8))
    counts = {"narrow_rle_writes": 0, "narrow_rle_reads": 0}
    for P in (bf, u8):
        label = str(P.dtype).split(".")[-1]
        P_bits = bits(torch, P).numpy()
        ref = write_reference(layout, O, L, C, P_bits)
        cfg = IOConfig(req_cap=O.shape[1], data_cap=P.shape[1],
                       coalesce_cap=64, cb_buffer_size=4096, pipeline=True,
                       pipeline_depth=2, kernel_fusion="fused_round",
                       slow_hop_codec="rle")
        kernels.reset_launch_counts()
        for name, mk, kw in (("twophase", make_twophase_write, {}),
                             ("tam", make_tam_write, {"use_kernels": True})):
            tag = f"small {name}/rle/{label}"
            f_gpu, s_gpu = mk(mesh, layout, cfg, device=dev, **kw)(O, L, C, P)
            f_cpu, s_cpu = mk(mesh, layout, cfg, device="cpu",
                              **kw)(O, L, C, P)
            require(f_gpu.dtype == P.dtype, f"{tag}: file dtype")
            require(raw(torch, f_gpu) == ref.tobytes() == raw(torch, f_cpu),
                    f"{tag}: file != write_reference / cpu")
            for k in s_cpu:
                require(s_gpu[k].cpu().tolist() == s_cpu[k].tolist(),
                        f"{tag}: stats {k} card != cpu")
            counts["narrow_rle_writes"] += 1
        file = torch.from_numpy(ref).view(P.dtype).reshape(4, -1)
        for name, mk in (("twophase", make_twophase_read),
                         ("tam", make_tam_read)):
            tag = f"small read {name}/rle/{label}"
            got = mk(mesh, layout, cfg, device=dev)(O, L, C, file).cpu()
            want = mk(mesh, layout, cfg, device="cpu")(O, L, C, file)
            require(raw(torch, got) == raw(torch, want), f"{tag}: card != cpu")
            for p in range(P.shape[0]):
                n = int(L[p].sum())
                require(raw(torch, got[p, :n]) == raw(torch, P[p, :n]),
                        f"{tag}: rank {p}")
            counts["narrow_rle_reads"] += 1
        seen = kernels.launch_counts()
        require(seen["zero_skip_encode"] > 0 and seen["zero_skip_decode"] > 0,
                f"rle {label}: the zero-skip kernels never ran")
    return counts


STALL = "Command Buffer Full"   # the profiler's record of a blocked launch


def _union_us(spans) -> float:
    """Total length of the union of ``(start, end)`` spans."""
    total, reach = 0.0, -math.inf
    for s, e in sorted(spans):
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total


# kernel wrappers timed by CUDA events in the profiled runs; the round
# engine's own steps come from its spans (repro_torch.trace) in the trace
STEPS = {"repro_torch.kernels.ops": ("sort_requests_with", "coalesce",
                                     "fused_drain_pack",
                                     "rle_zero_skip_encode",
                                     "rle_zero_skip_decode")}
PORT_KERNELS = ("sort_blocks_kernel", "sort_merge_kernel",
                "coalesce_cluster_kernel", "pack_tiles_kernel",
                "route_spans_kernel",
                "zero_skip_encode_rows_kernel",
                "zero_skip_encode_chunks_kernel", "zero_skip_zero_kernel",
                "zero_skip_scatter_kernel", "flash_tc_f32_kernel",
                "flash_tc_prefill_kernel", "flash_split_decode_kernel",
                "flash_split_merge_kernel", "flash_bwd_stats_kernel",
                "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")


@contextlib.contextmanager
def step_timers(torch, totals):
    """Wrap the kernel wrappers of ``STEPS`` so that each call records a
    CUDA event before and after it; on exit, ``totals[step]`` holds the
    summed event time (ms) and the call count. The stream is one queue
    that the host keeps full (the idle share is small), so an event
    pair spans the device time of the work enqueued between them."""
    import importlib
    spans, saved = {}, []

    def timed(name, fn):
        def run(*args, **kw):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = fn(*args, **kw)
            t1.record()
            spans.setdefault(name, []).append((t0, t1))
            return out
        return run

    for mod_name, names in STEPS.items():
        mod = importlib.import_module(mod_name)
        for name in names:
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, timed(name, getattr(mod, name)))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    torch.cuda.synchronize()
    for name, pairs in spans.items():
        totals[name] = {"ms": sum(a.elapsed_time(b) for a, b in pairs),
                        "calls": len(pairs)}


def profile_write(torch, write, inputs, top=10):
    """One write under torch.profiler: wall time, device busy time (the
    union of the spans of every kernel, copy and fill on the card), the
    idle share, the launches the host made wait on a full command queue,
    the port's kernels' device time, the event time of each kernel
    wrapper (``step_timers``), the calls and device time (children
    included) of each of the program's spans (``repro_torch.trace``) and
    the PyTorch operators whose kernels took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    steps = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with step_timers(torch, steps):
            t = time.perf_counter()
            write(*inputs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    spans, stalls = [], [0, 0.0]
    kernels = {k: 0.0 for k in PORT_KERNELS}
    for e in prof.events():
        us = e.time_range.end - e.time_range.start
        if e.name == STALL:
            stalls[0] += 1
            stalls[1] += us
            continue
        if e.device_type == DeviceType.CPU and e.name.startswith(
                "repro_torch."):
            step = steps.setdefault(e.name, {"ms": 0.0, "calls": 0})
            step["ms"] += e.device_time_total / 1e3
            step["calls"] += 1
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        for k in PORT_KERNELS:
            if k in e.name:
                kernels[k] += us / 1e3
    busy = _union_us(spans) * 1e-6
    ops = sorted(((e.self_device_time_total, e.count, e.key)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0), reverse=True)
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": max(0.0, 1.0 - busy / wall) if wall else None,
            "device_ops": len(spans), "stalled_launches": stalls[0],
            "stalled_ms": stalls[1] / 1e3, "port_kernels_ms": kernels,
            "steps": steps,
            "top_ops": [{"op": k, "calls": n, "device_ms": us / 1e3}
                        for us, n, k in ops[:top]]}


def phase_main(torch, dev):
    """The main path at deployment size: the two collective writes, the
    same writes with the rle codec on a half-zero payload, and the two
    rle reads of that file. Every run is timed alone after a warm-up
    run, with the launch counts set to 0 just before it and read just
    after; the profiled runs come after all counts are read."""
    from dataclasses import replace

    from repro_torch import kernels
    from repro_torch.core import (IOConfig, RankMesh, contiguous_layout,
                                  make_tam_read, make_tam_write,
                                  make_twophase_read, make_twophase_write,
                                  requests_from_numpy, write_reference)
    from repro_torch.io_patterns.generators import btio_write_pattern
    n_nodes = 16
    n_ranks = n_nodes * 64
    n_cells = 2048                   # 32 x 32 rank grid, 64 x 64 cells a rank
    t0 = time.perf_counter()
    O, L, C, D = btio_write_pattern(n_ranks, n_cells, 4, 8, seed=0)
    D_rle = sparse_cells(D, 0)
    file_len = 4 * n_cells * n_cells * 8
    layout = contiguous_layout(file_len, n_nodes)
    refs = {"dense": write_reference(layout, O, L, C, D),
            "rle": write_reference(layout, O, L, C, D_rle)}
    inputs = requests_from_numpy(O, L, C, D, device=dev)
    inputs_rle = requests_from_numpy(O, L, C, D_rle, device=dev)
    mesh = RankMesh(n_nodes, 1, 64)
    cfg = IOConfig(req_cap=O.shape[1], data_cap=D.shape[1], coalesce_cap=512,
                   cb_buffer_size=262144, kernel_fusion="fused_round")
    cfg_rle = replace(cfg, slow_hop_codec="rle")
    # name -> (run, inputs, payload for a write's reference / None)
    writes = {
        "twophase": (make_twophase_write(mesh, layout, cfg, device=dev),
                     inputs, "dense"),
        "tam": (make_tam_write(mesh, layout, cfg, use_kernels=True,
                               device=dev), inputs, "dense"),
        "twophase_rle": (make_twophase_write(mesh, layout, cfg_rle,
                                             device=dev), inputs_rle, "rle"),
        "tam_rle": (make_tam_write(mesh, layout, cfg_rle, use_kernels=True,
                                   device=dev), inputs_rle, "rle"),
    }
    readers = {"twophase_rle_read": make_twophase_read(mesh, layout,
                                                       cfg_rle, device=dev),
               "tam_rle_read": make_tam_read(mesh, layout, cfg_rle,
                                             device=dev)}
    plans = {**{k: v[0].plan for k, v in writes.items()},
             **{k: r.plan for k, r in readers.items()}}
    emit({"phase": "deployment", "ranks": n_ranks, "nodes": n_nodes,
          "ranks_per_node": 64, "n_cells": n_cells, "file_elems": file_len,
          "domain_len": plans["tam"].domain_len, "cb": plans["tam"].cb,
          "rounds": {k: pl.n_rounds for k, pl in plans.items()},
          "depth": {k: pl.pipeline_depth for k, pl in plans.items()},
          "req_cap": cfg.req_cap, "data_cap": cfg.data_cap,
          "rle_zero_cells": float((D_rle.reshape(n_ranks, -1, 8) == 0)
                                  .all(-1).mean()),
          "setup_s": time.perf_counter() - t0})

    launches, files, runs = {}, {}, {}

    def measured(name, fn, args):
        out, rec = run_measured(torch, dev, fn, args)
        launches[name] = rec["launches"]
        runs[name] = (fn, args)
        return out, rec

    for name, (w, args, payload) in writes.items():
        (f, stats), rec = measured(name, w, args)
        stats = {k: v.cpu().tolist() for k, v in stats.items()}
        files[name] = f.cpu().numpy().reshape(-1)
        require(files[name].tobytes() == refs[payload].tobytes(),
                f"{name}: file != write_reference")
        require(stats["dropped_requests"] == 0
                and stats["dropped_elems"] == 0, f"{name}: drops {stats}")
        emit({"phase": "main_path", "method": name, "direction": "write",
              **rec, "file_equals_reference": True, "stats": stats})
        if name == "twophase_rle":
            file_rle = f                 # read back by the rle reads
        del f
    for a, b in (("twophase", "tam"), ("twophase_rle", "tam_rle")):
        require(files[a].tobytes() == files[b].tobytes(),
                f"{a} file != {b} file")

    lengths = inputs_rle[1].to(torch.int64).sum(dim=1, keepdim=True)
    live = torch.arange(D.shape[1], device=dev) < lengths
    want = torch.where(live, inputs_rle[3], 0)
    for name, r in readers.items():
        got, rec = measured(name, r, (*inputs_rle[:3], file_rle))
        require(got.shape == want.shape and torch.equal(got, want),
                f"{name}: payloads != what each rank wrote")
        emit({"phase": "main_path", "method": name, "direction": "read",
              **rec, "payloads_equal_written": True})
        del got

    for name in ("tam", "tam_rle"):          # after the counts are read
        emit({"phase": "coalesce_rows", "method": name,
              **coalesce_rows(torch, *runs[name])})
    for name, (fn, args) in runs.items():
        emit({"phase": "profile", "method": name,
              **profile_write(torch, fn, args)})
    rle = ("zero_skip_encode", "zero_skip_decode")
    needed = {"twophase": ("fused_sort_pack",),
              "tam": ("fused_sort_pack", "bitonic_sort", "coalesce"),
              "twophase_rle": ("fused_sort_pack",) + rle,
              "tam_rle": ("fused_sort_pack", "bitonic_sort", "coalesce")
              + rle,
              "twophase_rle_read": rle, "tam_rle_read": rle}
    for method, names in needed.items():
        for k in names:
            require(launches[method][k] > 0, f"{method}: {k} never launched")
    return {k: sum(c[k] for c in launches.values())
            for k in kernels.launch_counts()}


def coalesce_rows(torch, fn, args) -> dict:
    """One more run of ``fn`` with ``kernels.ops.coalesce`` watched: how
    many live (non-pad) entries each row it coalesced held, beside the
    rows' capacity."""
    import importlib
    from repro_torch.core.requests import PAD_OFFSET
    ops = importlib.import_module("repro_torch.kernels.ops")
    seen, caps, saved = [], set(), ops.coalesce

    def watch(r):
        seen.append((r.offsets != PAD_OFFSET).sum(-1).reshape(-1))
        caps.add(r.capacity)
        return saved(r)

    ops.coalesce = watch
    try:
        fn(*args)
    finally:
        ops.coalesce = saved
    live = torch.cat(seen).to(torch.float64)
    return {"calls": len(seen), "rows": live.numel(),
            "capacity": sorted(caps), "live_mean": live.mean().item(),
            "live_min": live.min().item(), "live_max": live.max().item()}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@contextlib.contextmanager
def patched(module, name, wrap):
    """Run ``module.name`` as ``wrap(module.name)`` for the duration."""
    saved = getattr(module, name)
    setattr(module, name, wrap(saved))
    try:
        yield
    finally:
        setattr(module, name, saved)


def patched_attention(layers, wrap):
    """Run the model's attention as ``wrap(attention)`` for the
    duration."""
    return patched(layers, "flash_attention", wrap)


def watching(seen):
    """A ``patched_attention`` wrap that passes every call on unchanged
    and first hands its inputs to ``seen(q, k, v, kw)``."""
    def wrap(attention):
        def run(q, k, v, **kw):
            seen(q, k, v, kw)
            return attention(q, k, v, **kw)
        return run
    return wrap


def without_window(attention):
    """A planted fault: every local layer attends globally."""
    return lambda q, k, v, **kw: attention(q, k, v, **{**kw, "window": None})


def profile_serve(torch, layers, fn, args):
    """``profile_write`` of one serve run, plus the attention calls it
    made and the sum of their bounds (``attention_bound``), beside the
    flash kernel's device time, and the run's flash launches by
    route."""
    from repro_torch.kernels import flash
    calls = []
    before = dict(flash.flash_attention_fused.launches_by_route)
    with patched_attention(layers, watching(
            lambda q, k, v, kw: calls.append(attention_bound(
                torch, q.shape, k.shape, q.element_size(), kw["causal"],
                kw["window"], kw["q_offset"], kw.get("kv_len"))[0]))):
        rec = profile_write(torch, fn, args)
    by_route = {r: n - before[r] for r, n in
                flash.flash_attention_fused.launches_by_route.items()}
    return {**rec, "flash_calls": len(calls), "flash_bound_ms": sum(calls),
            "flash_launches_by_route": by_route}


def logit_stats(torch, got, want, chunk=512):
    """Relative L2 distance of two ``[B, S, V]`` logit tensors, their
    largest absolute difference and the share of rows whose greedy
    token agrees; in row chunks (the logits are 4 GB each)."""
    got, want = got.reshape(-1, got.shape[-1]), want.reshape(-1,
                                                             want.shape[-1])
    num = den = 0.0
    diff, same = 0.0, 0
    for i in range(0, got.shape[0], chunk):
        g, w = got[i:i + chunk].float(), want[i:i + chunk].float()
        num += float(((g - w) ** 2).sum())
        den += float((w ** 2).sum())
        diff = max(diff, float((g - w).abs().max()))
        same += int((g.argmax(-1) == w.argmax(-1)).sum())
    return {"rel_l2": math.sqrt(num / den), "max_abs_diff": diff,
            "top1_equal_share": same / got.shape[0]}


def row_rel_l2(got, want) -> list:
    """The relative L2 distance of each row of two ``[1, R, V]`` logit
    tensors."""
    g, w = got[0].float(), want[0].float()
    return ((g - w).norm(dim=-1) / w.norm(dim=-1)).tolist()


def layer_checks(ops, ref, captured, phase="serve_layer_checks",
                 kinds=("global", "local")) -> None:
    """The attention of the first layer of each kind (``kinds``) of a
    prefill (``captured``: kind -> the call's q, k, v and keywords)
    through the kernel and the plain version, held to the kernel phase's
    limits for the call's type; the planted faults must fail them."""
    checks = {}
    for kind, (q, k, v, kw) in sorted(captured.items()):
        tol = ATTN_TOL[str(q.dtype).split(".")[-1]]
        want = ref.flash_attention_ref(q, k, v, **kw)
        got = ops.fused_attention(q, k, v, **kw)
        planted = {f: attn_err(fn(), want, tol) for f, fn in
                   planted_faults(ops, q, k, v, got, kw).items()}
        checks[kind] = {
            **attn_err(got, want, tol), "tol": tol,
            "q": list(q.shape), "kv": list(k.shape), "causal": kw["causal"],
            "window": kw["window"],
            "planted_rel_l2": {f: c["rel_l2"] for f, c in planted.items()},
            "planted_within": {f: c["within"] for f, c in planted.items()}}
    emit({"phase": phase, "tol_rel_l2": ATTN_REL_L2, **checks})
    require(set(checks) == set(kinds),
            f"{phase}: captured layers {sorted(checks)}")
    for kind, c in checks.items():
        require(c["within"], f"serve {kind} layer attention: {c}")
        require(not any(c["planted_within"].values()),
                f"serve {kind} layer: a planted fault passes: {c}")


def phase_serve(torch, dev):
    """Greedy serving of gemma2-9b at full width and depth (42 layers,
    bf16 weights from a seeded ``torch.Generator``), through
    ``serve_traffic``:

    (a) ``generate`` at the reference CLI's defaults: batch 4, prompt
        32, 16 new tokens;
    (b) a batch-1 prefill of 8192 tokens (across the 4096 window of the
        local layers), then 16 greedy decode steps on that cache.

    Launch counts are set to 0 just before (a) and before (b) and read
    just after each. Checks: (b)'s prefill and decode logits equal the
    ``forward`` logits of the same 8208 tokens at the same positions
    (teacher forcing with the tokens it picked), and ``forward`` through
    the kernel equals ``forward`` with attention forced through
    ``flash_attention_ref``, and so do the two prefills, each within a
    relative L2 distance of ``SERVE_REL_L2``: bf16 activations rounded
    in other orders across 42 layers (the CPU tests hold the algorithm
    in f32 at 2e-3). The share of equal greedy tokens is printed, not
    required. The same distance for a forward whose local layers attend
    globally (a planted fault) must exceed ``SERVE_REL_L2``. Per layer, the
    attention inputs of the first local and the first global layer of
    the long prefill go through the kernel and the plain version (after
    the warm-up, before the counted run) and are held to the kernel
    phase's limits, which planted faults must fail."""
    from repro_torch import configs, kernels
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    cfg = configs.get("gemma2_9b")
    t0 = time.perf_counter()
    params = T.init_params(0, cfg, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    emit({"phase": "serve_setup", **param_record(cfg, params),
          "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
          "d_ff": cfg.d_ff, "window": cfg.window,
          "init_s": time.perf_counter() - t0})
    captured = {}        # the first local and global layer's inputs

    def watch():
        return patched_attention(layers, watching(
            lambda q, k, v, kw: captured.setdefault(
                "global" if kw["window"] is None else "local",
                (q, k, v, kw))))

    def checks():
        layer_checks(ops, ref, captured)
        captured.clear()
    traffic = serve_traffic(torch, dev, cfg, params, watch, checks)
    rec_a, rec_b = traffic["records"]
    for rec in (rec_a, rec_b):
        emit({"phase": "serve", **rec})
    gen_len, plen_b = GEN[2], LONG_PROMPT
    # every prefill layer on the tensor cores, every decode layer split
    per_run = route_counts(tc_prefill=cfg.n_layers,
                     split_decode=gen_len * cfg.n_layers)
    for rec in (rec_a, rec_b):
        require(rec["flash_launches_by_route"] == per_run,
                f"serve {rec['run']}: flash routes "
                f"{rec['flash_launches_by_route']}, expected {per_run}")

    # checks: decode vs forward, kernel vs plain attention
    full = torch.cat([traffic["prompt"], traffic["picked"]], dim=1)
    fwd, _ = T.forward(params, cfg, {"tokens": full})
    dec_vs_fwd = logit_stats(torch, traffic["served"], fwd[:, plen_b - 1:])
    require(dec_vs_fwd["rel_l2"] <= SERVE_REL_L2,
            f"decode vs forward logits: {dec_vs_fwd}")
    before = kernels.launch_counts()["flash_attention_fused"]
    with patched_attention(layers, lambda _: ref.flash_attention_ref):
        fwd_plain, _ = T.forward(params, cfg, {"tokens": full})
        prefill_plain, _ = T.prefill(params, cfg,
                                     {"tokens": traffic["prompt"]})
    require(kernels.launch_counts()["flash_attention_fused"] == before,
            "the plain-attention runs launched the kernel")
    kern_vs_plain = logit_stats(torch, fwd, fwd_plain)
    del fwd_plain
    with patched_attention(layers, without_window):
        fwd_planted, _ = T.forward(params, cfg, {"tokens": full})
    planted_vs_kern = logit_stats(torch, fwd_planted, fwd)
    del fwd, fwd_planted
    require(planted_vs_kern["rel_l2"] > SERVE_REL_L2,
            f"a forward with the window dropped passes: {planted_vs_kern}")
    prefill_vs_plain = logit_stats(torch, traffic["served"][:, :1],
                                   prefill_plain[:, None])
    for what, st in (("forward", kern_vs_plain),
                     ("prefill", prefill_vs_plain)):
        require(st["rel_l2"] <= SERVE_REL_L2,
                f"{what} through the kernel vs plain attention: {st}")
    emit({"phase": "serve_checks", "tokens": list(full.shape),
          "tol_rel_l2": SERVE_REL_L2,
          "decode_vs_forward": dec_vs_fwd,
          "forward_kernel_vs_plain": kern_vs_plain,
          "prefill_kernel_vs_plain": prefill_vs_plain,
          "planted_window_dropped_vs_kernel": planted_vs_kern,
          "ok": True})
    torch.cuda.empty_cache()
    pv32_run = perf_opts_generate(torch, dev, cfg, params,
                                  traffic["prompts"], rec_a)
    serve_profiles(torch, layers, cfg, params, traffic, "serve",
                   route_counts(tc_prefill=cfg.n_layers),
                   route_counts(split_decode=gen_len * cfg.n_layers))
    del params, traffic
    torch.cuda.empty_cache()
    launches, routes = traffic_counts(rec_a, rec_b)
    return ({k: launches[k] + pv32_run["launches"][k] for k in launches},
            add_routes(routes, pv32_run["flash_launches_by_route"]),
            pv32_run["launches_pv32"])


def perf_opts_generate(torch, dev, cfg, params, prompts, rec_a) -> dict:
    """gemma2-9b's generate cell (``GEN``) once more with
    ``REPRO_PERF_OPTS=0`` (``perf_opts_off``), after a warm-up: launch
    counts set to 0 just before it and read just after; every prefill
    layer must run on ``tc_prefill_pv32`` and every decode layer on
    ``split_decode_pv32``; the tokens must lie in the vocabulary (the
    default run's first row beside them); and, as the serve checks hold
    the default, the prefill's logits through the kernel must equal
    those through the plain attention (under the setting) within
    ``SERVE_REL_L2``."""
    from repro_torch.kernels import flash, ref
    from repro_torch.launch import serve
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    gen_len = GEN[2]
    with perf_opts_off():
        serve.generate(params, cfg, prompts, gen_len)            # warm-up
        out, ms, launches, routes, peak = counted(
            torch, dev, lambda: serve.generate(params, cfg, prompts,
                                               gen_len))
        pv32 = dict(flash.flash_attention_fused.launches_pv32)
        batch = serve.request_batch(cfg, prompts)
        kern, _ = T.prefill(params, cfg, batch)
        with patched_attention(layers, lambda _: ref.flash_attention_ref):
            plain, _ = T.prefill(params, cfg, batch)
    kern_vs_plain = logit_stats(torch, kern, plain)
    del kern, plain
    rec = {"phase": "perf_opts_serve", "run": "generate",
           "batch": prompts.shape[0], "prompt_len": prompts.shape[1],
           "new_tokens": gen_len, "generate_ms": ms, "peak_mem_bytes": peak,
           "launches": launches, "flash_launches_by_route": routes,
           "launches_pv32": pv32, "sample": out[0, :8].tolist(),
           "default_sample": rec_a["sample"],
           "prefill_kernel_vs_plain": kern_vs_plain,
           "tol_rel_l2": SERVE_REL_L2}
    emit(rec)
    require(tuple(out.shape) == (prompts.shape[0], gen_len + 1)
            and bool(((out >= 0) & (out < cfg.vocab)).all()),
            f"pv32 generate: tokens {tuple(out.shape)} out of range")
    want = route_counts(tc_prefill=cfg.n_layers,
                        split_decode=gen_len * cfg.n_layers)
    require(routes == want and pv32 == {
        "tc_prefill_pv32": want["tc_prefill"],
        "split_decode_pv32": want["split_decode"], "tc_f32_pv32": 0},
        f"pv32 generate: routes {routes}, f32 p.v {pv32}, expected {want}")
    require(kern_vs_plain["rel_l2"] <= SERVE_REL_L2,
            f"pv32 prefill through the kernel vs plain: {kern_vs_plain}")
    torch.cuda.empty_cache()
    return rec


# serving of the moe and ssm families (kimi-k2, mamba2-2.7b), and of the
# training phase's checkpoint
GEN = (4, 32, 16)             # generate: the reference CLI's defaults
KIMI_LAYERS = 1               # a layer's 384 experts take 33.8 GB in bf16
MOE_TOL = 2e-2                # the MoE layer, per element: see moe_check
MOE_CPU_CHUNK = 32            # experts copied to the host at once
# kimi-k2's logits at depth 1 carry one layer's bf16 roundings, not the
# 42 layers SERVE_REL_L2 allows for; and the attention adds about 3% of
# the residual there (the embedding dominates a seeded layer), so a
# wrong attention moves the logits by a few percent: the per-layer
# check's distance is the limit
KIMI_REL_L2 = ATTN_REL_L2


def watching_moe(seen):
    """A ``patched(layers, "moe", ...)`` wrap that hands each MoE call's
    parameters and input to ``seen(p, x)`` and runs it unchanged."""
    def wrap(moe):
        def run(p, x, cfg, **kw):
            seen(p, x)
            return moe(p, x, cfg, **kw)
        return run
    return wrap


def without_causal(attention):
    """A planted fault: every query attends to later keys too."""
    return lambda q, k, v, **kw: attention(q, k, v, **{**kw, "causal": False})


def route_counts(tc_prefill=0, split_decode=0, tc_f32=0) -> dict:
    """Flash launches by route, as ``launches_by_route`` counts them."""
    return {"tc_prefill": tc_prefill, "split_decode": split_decode,
            "tc_f32": tc_f32}


def add_routes(a: dict, b: dict) -> dict:
    return {r: a[r] + b[r] for r in a}


def synced(torch, fn):
    """``fn()`` and its wall in ms between two device synchronisations."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def counted(torch, dev, fn):
    """``synced(fn)`` with every launch count and the peak memory reset
    just before it: (out, ms, launches, flash routes, peak bytes)."""
    from repro_torch import kernels
    from repro_torch.kernels import flash
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    out, ms = synced(torch, fn)
    return out, ms, kernels.launch_counts(), dict(
        flash.flash_attention_fused.launches_by_route), \
        torch.cuda.max_memory_allocated(dev)


def served_request(torch, dev, cfg, params, batch, gen_len, run,
                   watch=contextlib.nullcontext, checks=lambda: None,
                   plan=None, decode_plan=None):
    """One request as the reference's tests drive one: a warm-up prefill
    of ``batch`` under ``watch()`` (to capture a layer's inputs), then
    ``checks()`` (so that the counted run holds no captured tensor),
    then the counted run: the prefill and ``gen_len`` greedy decode
    steps, every launch count set to 0 just before it and read just
    after. ``plan`` and ``decode_plan`` are the prefill's and the decode
    steps' sharding plans (none: one device). Returns (record, picked
    tokens ``[B, gen_len]``, served logit rows ``[B, gen_len + 1, V]``:
    the prefill's last row, then each decode step's)."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    with watch():
        T.prefill(params, cfg, batch, plan=plan)            # warm-up
    checks()
    picked, rows = [], []

    def run_it():
        logits, state = T.prefill(params, cfg, batch, plan=plan)
        rows.append(logits)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = serve._grow_caches(state, gen_len)
        tok = serve.pick(logits, cfg.vocab)
        for _ in range(gen_len):
            picked.append(tok)
            logits, state = T.decode_step(params, cfg, state, tok,
                                          plan=decode_plan)
            rows.append(logits)
            tok = serve.pick(logits, cfg.vocab)
        return t
    t_dec, total_ms, launches, by_route, peak = counted(torch, dev, run_it)
    decode_ms = (time.perf_counter() - t_dec) * 1e3
    b, plen = batch["tokens"].shape
    rec = {"run": run, "batch": b, "prompt_len": plen,
           **({"prefix_rows": batch["prefix_embeds"].shape[1]}
              if "prefix_embeds" in batch else {}),
           **({"frames": list(batch["frames"].shape[1:]),
               "frames_dtype": str(batch["frames"].dtype)}
              if "frames" in batch else {}),
           "new_tokens": gen_len, "prefill_ms": total_ms - decode_ms,
           "prefill_tokens_per_s": b * plen / (total_ms - decode_ms) * 1e3,
           "decode_ms_per_step": decode_ms / gen_len,
           "decode_tokens_per_s": b * gen_len / decode_ms * 1e3,
           "peak_mem_bytes": peak, "launches": launches,
           "flash_launches_by_route": by_route}
    torch.cuda.empty_cache()
    return rec, torch.stack(picked, dim=1), torch.stack(rows, dim=1)


def serve_traffic(torch, dev, cfg, params, watch=contextlib.nullcontext,
                  checks=lambda: None, long_extra=None, long_len=None,
                  long_gen=None, plan=None, decode_plan=None):
    """The serving cells of ``phase_serve`` on another model: (a)
    ``serve.generate`` at ``GEN`` (batch 4, prompt 32, 16 new tokens),
    then its prefill (``serve.request_batch``) and decode loop timed
    apart; (b) ``served_request`` of a batch-1 prompt of ``long_len``
    (default ``LONG_PROMPT``) tokens (with ``long_extra``'s inputs: a
    vlm's prefix, an enc-dec's frames) and ``long_gen`` (default 16)
    greedy decode steps; ``plan`` and ``decode_plan`` are the prefills'
    and the decode steps' sharding plans (none: one device). Each
    counted run follows a warm-up, with every launch count set to 0 just
    before it and read just after; (b)'s warm-up prefill runs under
    ``watch()`` and ``checks()`` runs after it. Returns the two runs'
    records (with their launches and flash routes), the prompts, the
    long request's batch, the picked tokens and the served logit rows
    ``[1, long_gen + 1, V]``."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    batch, plen, gen_len = GEN

    prompts = torch.randint(0, cfg.vocab, (batch, plen), generator=gen,
                            device=dev, dtype=torch.int32)
    plans = dict(plan=plan, decode_plan=decode_plan)
    serve.generate(params, cfg, prompts, gen_len, **plans)  # warm-up
    out, gen_ms, launches_a, routes_a, peak_a = counted(
        torch, dev, lambda: serve.generate(params, cfg, prompts, gen_len,
                                           **plans))
    require(tuple(out.shape) == (batch, gen_len + 1)
            and bool(((out >= 0) & (out < cfg.vocab)).all()),
            f"{cfg.name} generate: tokens {tuple(out.shape)} out of range")
    (_, state), prefill_ms = synced(torch, lambda: T.prefill(
        params, cfg, serve.request_batch(cfg, prompts), plan=plan))
    state = serve._grow_caches(state, gen_len)

    def decode_loop(state, tok, n):
        for _ in range(n):
            logits, state = T.decode_step(params, cfg, state, tok,
                                          plan=decode_plan)
            tok = serve.pick(logits, cfg.vocab)
        return state
    _, decode_ms = synced(torch, lambda: decode_loop(state, out[:, 0],
                                                     gen_len))
    del state
    rec_a = {"run": "generate", "batch": batch, "prompt_len": plen,
             "new_tokens": gen_len, "generate_ms": gen_ms,
             "tokens_per_s": batch * (gen_len + 1) / gen_ms * 1e3,
             "prefill_ms": prefill_ms,
             "decode_ms_per_step": decode_ms / gen_len,
             "decode_tokens_per_s": batch * gen_len / decode_ms * 1e3,
             "peak_mem_bytes": peak_a, "launches": launches_a,
             "flash_launches_by_route": routes_a,
             "sample": out[0, :8].tolist()}

    long_len = LONG_PROMPT if long_len is None else long_len
    prompt = torch.randint(0, cfg.vocab, (1, long_len), generator=gen,
                           device=dev, dtype=torch.int32)
    long_batch = {"tokens": prompt, **(long_extra or {})}
    long_gen = gen_len if long_gen is None else long_gen
    rec_b, picked, served = served_request(
        torch, dev, cfg, params, long_batch, long_gen, "long_prompt", watch,
        checks, **plans)
    return {"records": (rec_a, rec_b), "prompts": prompts, "prompt": prompt,
            "long_batch": long_batch, "long_gen": long_gen,
            "picked": picked, "served": served}


def serve_profiles(torch, layers, cfg, params, traffic, what, prefill_routes,
                   decode_routes, plan=None, decode_plan=None):
    """The ``profile`` lines of a serving phase (after its counts are
    read): ``generate``, the long request's prefill, and its first
    ``GEN[2]`` decode steps (reading a profile back costs about a
    millisecond an event: whisper's 448 steps took 183 s on an H100
    host); the prefill's and the decode's flash launches must be
    ``prefill_routes`` and ``decode_routes``; ``plan`` and
    ``decode_plan`` as ``serve_traffic``'s. Returns the three profile
    records."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    batch = traffic["long_batch"]
    gen_len = min(traffic["long_gen"], GEN[2])
    plen = batch["tokens"].shape[1]
    profs = {"generate": profile_serve(
        torch, layers, lambda *a: serve.generate(
            *a, plan=plan, decode_plan=decode_plan),
        (params, cfg, traffic["prompts"], GEN[2]))}
    emit({"phase": "profile", "method": f"{what}_generate",
          **profs["generate"]})
    prof = profile_serve(torch, layers, lambda *a: T.prefill(*a, plan=plan),
                         (params, cfg, batch))
    profs["prefill"] = prof
    emit({"phase": "profile", "method": f"{what}_prefill_{plen}", **prof})
    require(prof["flash_launches_by_route"] == prefill_routes,
            f"{what} prefill: {prof['flash_launches_by_route']}, expected "
            f"{prefill_routes}")
    _, state = T.prefill(params, cfg, batch, plan=plan)
    state = serve._grow_caches(state, gen_len)

    def decode_loop(state, tok):
        for _ in range(gen_len):
            logits, state = T.decode_step(params, cfg, state, tok,
                                          plan=decode_plan)
            tok = serve.pick(logits, cfg.vocab)
    prof = profile_serve(torch, layers, decode_loop,
                         (state, traffic["picked"][:, 0]))
    profs["decode"] = prof
    emit({"phase": "profile",
          "method": f"{what}_decode_{gen_len}_at_{plen}", **prof})
    require(prof["flash_launches_by_route"] == decode_routes,
            f"{what} decode: {prof['flash_launches_by_route']}, expected "
            f"{decode_routes}")
    del state
    torch.cuda.empty_cache()
    return profs


def param_record(cfg, params) -> dict:
    return {"config": cfg.name, "family": cfg.family,
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab,
            "params": sum(t.numel() for t in _leaves(params)),
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in _leaves(params))}


def cpu_f32(torch, t, chunk):
    """``t`` as an f32 tensor on the host: ``chunk`` rows of its first
    axis at a time through a pinned staging buffer in ``t``'s type, then
    converted on the host (exactly, from bf16)."""
    out = torch.empty(t.shape, dtype=torch.float32)
    stage = torch.empty((min(chunk, t.shape[0]), *t.shape[1:]),
                        dtype=t.dtype, pin_memory=True)
    for i in range(0, t.shape[0], chunk):
        n = min(chunk, t.shape[0] - i)
        stage[:n].copy_(t[i:i + n])
        out[i:i + n].copy_(stage[:n])
    return out


def moe_check(torch, layers, cfg, p, x, keep=None) -> dict:
    """The MoE layer of the long prefill (its parameters ``p`` and input
    ``x``, captured) on the card in bf16 against the same call,
    ``layers.moe``, on the CPU in f32 (the weights converted exactly).
    The routing must agree exactly: the same top-k experts for every
    token and the same dropped (token, k) entries. The outputs: relative
    L2 within ``ATTN_REL_L2`` (the per-layer attention check's) and
    every element within atol = rtol = ``MOE_TOL``. That is not the
    attention's one bf16 ulp (8e-3): the layer rounds to bf16 four times
    in a row (h and g, the SwiGLU product, each expert's output, the
    gated sum), and an element of the expert output sums 2048 products
    of rounded terms; the reading against 8e-3 is printed beside. A
    planted fault, the layer run with top-k one short (a token loses its
    last expert and its gates renormalise), must fail the limits. With
    ``keep``, the host's f32 copy of the weights stays in
    ``keep["p_h"]`` for the mesh'd checks (``mesh_moe_check``)."""
    import dataclasses
    import gc
    n, d = x.shape[0] * x.shape[1], x.shape[-1]
    out_c, aux_c = layers.moe(p, x, cfg)
    route_c = layers.moe_route(p, x.reshape(n, d), cfg)
    short = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, top_k=cfg.moe.top_k - 1))
    planted, _ = layers.moe(p, x, short)
    t0 = time.perf_counter()
    p_h = {k: cpu_f32(torch, v, MOE_CPU_CHUNK) for k, v in p.items()}
    x_h = x.float().cpu()
    convert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_h, aux_h = layers.moe(p_h, x_h, cfg)
    cpu_s = time.perf_counter() - t0
    route_h = layers.moe_route(p_h, x_h.reshape(n, d), cfg)
    if keep is not None:
        keep["p_h"] = p_h
    del p_h, x_h
    gc.collect()
    want = out_h.to(out_c.dtype)
    drops_c, drops_h = route_c.dropped().cpu(), route_h.dropped()
    got = out_c.cpu()
    check = attn_err(got, want, MOE_TOL)
    at_attn = attn_err(got, want, ATTN_TOL["bfloat16"])
    fault = attn_err(planted.cpu(), want, MOE_TOL)
    rec = {"tokens": n, "experts": cfg.moe.num_experts,
           "top_k": cfg.moe.top_k, "capacity": route_c.cap,
           "eids_equal": bool(torch.equal(route_c.eids.cpu(),
                                          route_h.eids)),
           "drops_equal": bool(torch.equal(drops_c, drops_h)),
           "dropped": int(drops_c.sum()),
           "tokens_with_a_drop": int(drops_c.any(-1).sum()),
           "aux": float(aux_c), "aux_cpu_f32": float(aux_h),
           "tol": MOE_TOL, "tol_rel_l2": ATTN_REL_L2, **check,
           "within_attention_tol": at_attn["within"],
           "worst_over_attention_tol": float(
               ((got.float() - want.float()).abs()
                / (ATTN_TOL["bfloat16"] * (1 + want.float().abs()))).max()),
           "planted_top_k_short": {k: fault[k] for k in (
               "max_abs_err", "rel_l2", "within")},
           "cpu_convert_s": convert_s, "cpu_moe_s": cpu_s,
           "cpu_threads": torch.get_num_threads()}
    emit({"phase": "serve_moe_layer_check", **rec})
    require(rec["eids_equal"] and rec["drops_equal"],
            f"moe: the card's routing differs from the CPU's: {rec}")
    require(check["within"], f"moe layer vs CPU f32: {rec}")
    require(not fault["within"], f"moe: the planted fault passes: {rec}")
    return rec


def phase_serve_moe(torch, dev):
    """Greedy serving of kimi-k2 (moe) at full width, cut to
    ``KIMI_LAYERS`` layer: d 7168, 64 query over 8 kv heads of 112, 384
    experts of d_ff 2048, top-8, capacity factor 1.25, vocab 163840;
    bf16 weights from a seeded ``torch.Generator`` (38.9 GB at depth 1,
    33.8 GB of them experts). The traffic of ``phase_serve``
    (``serve_traffic``): generate 4 x 32 + 16, and an 8192 prefill with
    16 decode steps; every prefill layer on ``tc_prefill``, every decode
    layer on ``split_decode`` (required).

    Checks, each failing the run: the served logits (the prefill's last
    row, each decode step's) against teacher-forced ``forward`` logits
    of the same tokens, relative L2 within ``KIMI_REL_L2``, on the rows
    whose token the forward and the serving path dispatched alike (a
    forward over 8208 tokens may drop a decoded token's entries where a
    decode step at batch 1 drops none; those rows are left out and
    counted); ``forward`` and the long prefill through the kernels
    against attention forced through ``flash_attention_ref``, within the
    same limit, where a forward whose attention drops the causal mask (a
    planted fault) must not be; the attention of the long prefill's
    layer against the plain version (``layer_checks``); and the MoE
    layer of the long prefill against the same call on the CPU in f32
    (``moe_check``). Then ``phase_serve_mesh`` serves the same weights
    on the emulated production mesh, reusing the host's f32 copy.
    Returns the launches and flash routes of the four counted runs."""
    import dataclasses
    from repro_torch import configs, kernels
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(configs.get("kimi_k2"), n_layers=KIMI_LAYERS)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = T.init_params(0, cfg, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    emit({"phase": "serve_moe_setup", **param_record(cfg, params),
          "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
          "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
          "d_ff_expert": cfg.moe.d_ff_expert,
          "capacity_factor": cfg.moe.capacity_factor,
          "cut": f"depth 61 -> {KIMI_LAYERS}",
          "init_s": time.perf_counter() - t0})
    captured, moe_in, found = {}, [], {}

    @contextlib.contextmanager
    def watch():
        with patched_attention(layers, watching(
                lambda q, k, v, kw: captured.setdefault(
                    "global", (q, k, v, kw)))), \
                patched(layers, "moe", watching_moe(
                    lambda p, x: moe_in.append((p, x)))):
            yield

    def checks():
        layer_checks(ops, ref, captured, "serve_moe_layer_checks",
                     ("global",))
        p, x = moe_in.pop()
        found["moe"] = moe_check(torch, layers, cfg, p, x, keep=found)
        found["prefill_drops"] = layers.moe_route(
            p, x.reshape(-1, cfg.d_model), cfg).dropped().any(-1)
        captured.clear()
        torch.cuda.empty_cache()
    traffic = serve_traffic(torch, dev, cfg, params, watch, checks)
    gen_len = GEN[2]
    rec_a, rec_b = traffic["records"]
    for rec in (rec_a, rec_b):
        emit({"phase": "serve_moe", **rec})
    per_run = route_counts(tc_prefill=cfg.n_layers,
                     split_decode=gen_len * cfg.n_layers)
    for rec in (rec_a, rec_b):
        require(rec["flash_launches_by_route"] == per_run,
                f"serve_moe {rec['run']}: flash routes "
                f"{rec['flash_launches_by_route']}, expected {per_run}")

    # decode vs teacher-forced forward, on the rows dispatched alike
    full = torch.cat([traffic["prompt"], traffic["picked"]], dim=1)
    fwd_moe = []
    with patched(layers, "moe", watching_moe(
            lambda p, x: fwd_moe.append(layers.moe_route(
                p, x.reshape(-1, cfg.d_model), cfg).dropped().any(-1)))):
        fwd, _ = T.forward(params, cfg, {"tokens": full})
    plen = LONG_PROMPT
    fwd_drop = torch.stack(fwd_moe).any(0).cpu()           # [8208]
    served_drop = torch.cat([found["prefill_drops"][-1:].cpu(),
                             torch.zeros(gen_len, dtype=torch.bool)])
    differs = fwd_drop[plen - 1:] != served_drop            # [17]
    if cfg.n_layers > 1:      # a later layer's attention reads the rows
        differs = torch.cumsum(differs, 0) > 0
    keep = (~differs).nonzero().reshape(-1).tolist()
    dec_vs_fwd = logit_stats(torch, traffic["served"][:, keep],
                             fwd[:, plen - 1:][:, keep]) if keep else {}
    before = kernels.launch_counts()["flash_attention_fused"]
    with patched_attention(layers, lambda _: ref.flash_attention_ref):
        fwd_plain, _ = T.forward(params, cfg, {"tokens": full})
        prefill_plain, _ = T.prefill(params, cfg,
                                     {"tokens": traffic["prompt"]})
    require(kernels.launch_counts()["flash_attention_fused"] == before,
            "the plain-attention runs launched the kernel")
    kern_vs_plain = logit_stats(torch, fwd, fwd_plain)
    del fwd_plain
    with patched_attention(layers, without_causal):
        fwd_planted, _ = T.forward(params, cfg, {"tokens": full})
    planted_vs_kern = logit_stats(torch, fwd_planted, fwd)
    del fwd, fwd_planted
    prefill_vs_plain = logit_stats(torch, traffic["served"][:, :1],
                                   prefill_plain[:, None])
    emit({"phase": "serve_moe_checks", "tokens": list(full.shape),
          "tol_rel_l2": KIMI_REL_L2, "rows_compared": keep,
          "rows_left_out": gen_len + 1 - len(keep),
          "forward_dropped_tokens": int(fwd_drop.sum()),
          "decode_vs_forward": dec_vs_fwd,
          "forward_kernel_vs_plain": kern_vs_plain,
          "prefill_kernel_vs_plain": prefill_vs_plain,
          "planted_causal_dropped_vs_kernel": planted_vs_kern,
          "moe_layer_dropped": found["moe"]["dropped"]})
    require(len(keep) >= 1 + gen_len // 2,
            f"serve_moe: only rows {keep} were dispatched alike")
    for what, st in (("decode vs forward", dec_vs_fwd),
                     ("forward through the kernel vs plain", kern_vs_plain),
                     ("prefill through the kernel vs plain",
                      prefill_vs_plain)):
        require(st["rel_l2"] <= KIMI_REL_L2, f"serve_moe {what}: {st}")
    require(planted_vs_kern["rel_l2"] > KIMI_REL_L2,
            f"a forward without the causal mask passes: {planted_vs_kern}")
    torch.cuda.empty_cache()
    profs = serve_profiles(torch, layers, cfg, params, traffic, "serve_moe",
                           route_counts(tc_prefill=cfg.n_layers),
                           route_counts(split_decode=gen_len * cfg.n_layers))
    del traffic
    torch.cuda.empty_cache()
    counts, routes = traffic_counts(rec_a, rec_b)
    mesh_counts, mesh_routes = phase_serve_mesh(
        torch, dev, cfg, params, found,
        {"generate": rec_a, "long_prompt": rec_b, "profiles": profs})
    del params, found
    torch.cuda.empty_cache()
    return ({k: counts[k] + mesh_counts[k] for k in counts},
            add_routes(routes, mesh_routes))


def traffic_counts(rec_a, rec_b):
    """The launches and flash routes of a serving phase's two counted
    runs, summed."""
    a, b = rec_a["launches"], rec_b["launches"]
    ra, rb = rec_a["flash_launches_by_route"], rec_b["flash_launches_by_route"]
    return {k: a[k] + b[k] for k in a}, {r: ra[r] + rb[r] for r in ra}


# ---------------------------------------------------------------------------
# the mesh paths on an emulated rank grid: kimi-k2 served on the
# production mesh, the two-layer gradient sync, the GPipe pipeline
# ---------------------------------------------------------------------------

MESH_DECODE_DROP_ROWS = 8     # at most this many of 17 rows may differ
MESH_PIPE = (4, 8, 4096)      # stages, microbatches, tokens a microbatch
COLLECTIVE_GRID = (2, 4)      # (pod, ici): 8 ranks' gradients
COLLECTIVE_REL = 1e-6         # two_layer_psum: of max |sum| (f32 order)
EF_BOUND = 5e-2               # compressed_psum: spmd_checks' bound


def mesh_plans():
    """The production mesh (data 16, model 16) and ``plan_for_cell``'s
    plans for the served cells: the prefills (4 x 32, 1 x 8192) and the
    decode steps (against 48 and 8208 positions). The batch does not
    divide the 16 data ranks in any of them, so every plan drops its
    data axes; the prefills shard the sequence over the model axis."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.launch.steps import plan_for_cell
    mesh = make_production_mesh()
    b, plen, gen_len = GEN
    cells = (ShapeCell("prefill_4x32", "prefill", plen, b),
             ShapeCell("prefill_1x8192", "prefill", LONG_PROMPT, 1),
             ShapeCell("decode_4x48", "decode", plen + gen_len, b),
             ShapeCell("decode_1x8208", "decode", LONG_PROMPT + gen_len, 1))
    plans = [plan_for_cell(mesh, c) for c in cells]
    require(plans[0] == plans[1] and plans[2] == plans[3],
            f"the served cells' plans differ: {plans}")
    return mesh, plans[0], plans[2], {
        c.name: {"data_axes": list(p.data_axes), "shard_seq": p.shard_seq}
        for c, p in zip(cells, plans)}


def recording_moe(store):
    """A ``patched(layers, "moe", ...)`` wrap that stores each call's
    ``(p, x, plan)`` and runs it unchanged."""
    def wrap(moe):
        def run(p, x, cfg, plan=None):
            store.append((p, x, plan))
            return moe(p, x, cfg, plan=plan)
        return run
    return wrap


def mesh_moe_check(torch, layers, cfg, p, x, plan, p_h, what) -> dict:
    """A mesh'd MoE layer call (``moe_sharded`` on the emulated ranks)
    on the card in bf16 against the same call on the CPU in f32 (``p_h``,
    the weights converted exactly by ``moe_check``): every rank's top-k
    experts and the slot of every (token, k) entry equal, the dropped
    ones included; the outputs within ``moe_check``'s limits; the layer
    run with top-k one short (a planted fault) must fail them."""
    import dataclasses
    from repro_torch.models import moe_sharded as MS
    require(torch.equal(p["router"].float().cpu(), p_h["router"]),
            f"{what}: the host copy is not this layer's")
    out_c, aux_c = layers.moe(p, x, cfg, plan=plan)
    route_c = MS.sharded_route(p, x, cfg, plan)
    short = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, top_k=cfg.moe.top_k - 1))
    planted, _ = layers.moe(p, x, short, plan=plan)
    x_h = x.float().cpu()
    t0 = time.perf_counter()
    out_h, aux_h = layers.moe(p_h, x_h, cfg, plan=plan)
    cpu_s = time.perf_counter() - t0
    route_h = MS.sharded_route(p_h, x_h, cfg, plan)
    want = out_h.to(out_c.dtype)
    got = out_c.cpu()
    check = attn_err(got, want, MOE_TOL)
    fault = attn_err(planted.cpu(), want, MOE_TOL)
    lay = route_c.layout
    rec = {"what": what, "tokens": list(x.shape[:2]),
           "ranks": dict(zip(lay.ranks.names, lay.ranks.sizes)),
           "form": "sequence-sharded" if plan.shard_seq else "decode",
           "tokens_a_rank": lay.n_loc, "capacity": lay.cap,
           "experts_a_rank": lay.e_loc,
           "eids_equal": bool(torch.equal(route_c.eids.cpu(),
                                          route_h.eids)),
           "slots_equal": bool(torch.equal(route_c.slot.cpu(),
                                           route_h.slot)),
           "dropped_entries": int(route_c.dropped_kept().sum()),
           "tokens_with_a_drop": int(route_c.token_dropped().sum()),
           "aux": float(aux_c), "aux_cpu_f32": float(aux_h),
           "tol": MOE_TOL, "tol_rel_l2": ATTN_REL_L2, **check,
           "planted_top_k_short": {k: fault[k] for k in (
               "max_abs_err", "rel_l2", "within")},
           "cpu_moe_s": cpu_s}
    emit({"phase": "serve_mesh_moe_check", **rec})
    require(rec["eids_equal"] and rec["slots_equal"],
            f"mesh moe {what}: the card's routing differs from the CPU's")
    require(check["within"], f"mesh moe {what} vs CPU f32: {rec}")
    require(not fault["within"], f"mesh moe {what}: the planted fault "
            f"passes: {rec}")
    return rec


def teacher_forced(torch, params, cfg, batch, picked, plan, decode_plan,
                   store):
    """The prefill of ``batch`` and a decode step for each of ``picked``
    ``[1, n]`` under the plans, with every MoE call stored
    (``recording_moe``): the logit rows ``[1, n + 1, V]``."""
    from repro_torch.launch import serve
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    with patched(layers, "moe", recording_moe(store)):
        logits, state = T.prefill(params, cfg, batch, plan=plan)
        rows = [logits]
        state = serve._grow_caches(state, picked.shape[1])
        for t in range(picked.shape[1]):
            logits, state = T.decode_step(params, cfg, state, picked[:, t],
                                          plan=decode_plan)
            rows.append(logits)
    return torch.stack(rows, dim=1)


def without_pmax(pmax):
    """A planted fault in ``decode_attention_sharded``: each rank's
    partial softmax keeps its own row max (no ``pmax`` before the
    merge)."""
    return lambda x, ranks, axis: x


def phase_serve_mesh(torch, dev, cfg, params, found, base):
    """kimi-k2 served through the mesh paths on the production mesh
    (``mesh_plans``: data 16 x model 16 = 256 emulated ranks; the data
    axes drop at batch 4 and 1), with ``phase_serve_moe``'s weights (full
    width, depth 1) and its host f32 copy (``found["p_h"]``): the MoE
    layers run ``moe_sharded`` (the sequence-sharded form at prefill,
    the decode form at decode) and a decode step's attention runs
    ``decode_attention_sharded`` (plain PyTorch, as the reference's
    ``jnp``); the prefill's attention stays on ``tc_prefill``. The
    traffic is ``serve_traffic``'s (4 x 32 + 16, 1 x 8192 + 16), printed
    beside ``base`` (the unsharded runs' records and profiles).

    Checks, each failing the run: (a) ``mesh_moe_check`` of the long
    prefill's MoE layer and of a decode step's; (b) the mesh'd logits
    of the long request (teacher-forced on its picked tokens) against
    the unsharded path's within ``KIMI_REL_L2`` on the rows that both
    paths dispatched alike (at depth 1 the KV cache precedes the MoE,
    so the caches are equal; the rows where the decode form dropped an
    entry, or the prefill's capacities differ, are left out and
    counted); (c) ``decode_attention_sharded`` against the
    ``split_decode`` kernel on the last decode step's query and 8208
    cache, within the attention limits, where (d) a merge without the
    ``pmax`` (``without_pmax``) must fail them; (e)
    ``two_layer_all_to_all`` of the long prefill's dispatch buckets
    (``[16 ranks, 384, 16, 7168]``) arranged as (pod 2, ici 8) equals
    the flat transpose bit for bit. Returns the counted runs' launches
    and flash routes."""
    from repro_torch import compat
    from repro_torch.core import hierarchical as H
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers
    from repro_torch.models import moe_sharded as MS
    mesh, plan, dplan, cells = mesh_plans()
    gen_len = GEN[2]
    emit({"phase": "serve_mesh_setup", "config": cfg.name,
          "mesh": mesh.shape, "ranks": mesh.size, "cells": cells,
          "layers": cfg.n_layers})
    seen = []

    def checks():
        p, x, pl = seen.pop()
        require(pl is plan, "the long prefill's MoE ran another plan")
        found["mesh_prefill"] = (p, x)
        found["mesh_moe"] = mesh_moe_check(torch, layers, cfg, p, x, plan,
                                           found["p_h"], "long_prefill")
        torch.cuda.empty_cache()
    traffic = serve_traffic(
        torch, dev, cfg, params,
        lambda: patched(layers, "moe", recording_moe(seen)), checks,
        plan=plan, decode_plan=dplan)
    rec_a, rec_b = traffic["records"]
    per_run = route_counts(tc_prefill=cfg.n_layers)
    for rec, name in ((rec_a, "generate"), (rec_b, "long_prompt")):
        unsharded = base[name]
        emit({"phase": "serve_mesh", **rec, "unsharded": {
            k: unsharded.get(k) for k in (
                "prefill_ms", "decode_ms_per_step", "generate_ms",
                "tokens_per_s", "decode_tokens_per_s", "peak_mem_bytes")}})
        require(rec["flash_launches_by_route"] == per_run,
                f"serve_mesh {rec['run']}: flash routes "
                f"{rec['flash_launches_by_route']}, expected {per_run}")

    # (b) mesh'd vs unsharded logits, teacher-forced on the same tokens;
    # (c), (d): the last decode step's sharded attention vs the kernel
    batch = {"tokens": traffic["prompt"]}
    picked = traffic["picked"]
    attn_in = {}

    def capture_attention(fn):
        def run(q, k, v, **kw):
            attn_in["last"] = (q, k, v, kw)
            return fn(q, k, v, **kw)
        return run
    mesh_moe, flat_moe = [], []
    with patched(layers, "decode_attention_sharded", capture_attention):
        rows_mesh = teacher_forced(torch, params, cfg, batch, picked, plan,
                                   dplan, mesh_moe)
    rows_flat = teacher_forced(torch, params, cfg, batch, picked, None, None,
                               flat_moe)
    served_equal = bool(torch.equal(rows_mesh, traffic["served"]))
    mesh_lost = [MS.sharded_route(p, x, cfg, pl).token_dropped()[:, -1]
                 for p, x, pl in mesh_moe]
    flat_lost = [layers.moe_route(p, x.reshape(-1, cfg.d_model), cfg)
                 .dropped().any(-1).reshape(x.shape[:2])[:, -1]
                 for p, x, _ in flat_moe]
    require(len(mesh_lost) == len(flat_lost) == gen_len + 1,
            "one MoE call a row expected at depth 1")
    lost_m = torch.cat(mesh_lost).cpu()
    lost_f = torch.cat(flat_lost).cpu()
    keep = (~lost_m & ~lost_f).nonzero().reshape(-1).tolist()
    per_row = row_rel_l2(rows_mesh, rows_flat)
    mesh_vs_flat = logit_stats(torch, rows_mesh[:, keep],
                               rows_flat[:, keep]) if keep else {}
    step = next((i for i in range(1, gen_len + 1) if bool(lost_m[i])), 1)
    p, x, pl = mesh_moe[step]
    found["mesh_decode_moe"] = mesh_moe_check(
        torch, layers, cfg, p, x, pl, found["p_h"], f"decode_step_{step}")
    del mesh_moe, flat_moe
    found.pop("p_h")

    q, k, v, kw = attn_in["last"]
    pos = kw["cache_pos"]
    got = layers.decode_attention_sharded(q, k, v, **kw)
    kern = ops.fused_attention(q, k, v, causal=False, window=kw["window"],
                               logit_cap=kw["logit_cap"], q_offset=pos,
                               kv_len=pos + 1).reshape(got.shape)
    plain = ref.flash_attention_ref(q, k, v, causal=False,
                                    window=kw["window"],
                                    logit_cap=kw["logit_cap"], q_offset=pos,
                                    kv_len=pos + 1).reshape(got.shape)
    tol = ATTN_TOL[str(q.dtype).split(".")[-1]]
    vs_kernel = attn_err(got, kern, tol)
    with patched(compat, "pmax", without_pmax):
        planted = attn_err(layers.decode_attention_sharded(q, k, v, **kw),
                           kern, tol)
    emit({"phase": "serve_mesh_checks", "tol_rel_l2": KIMI_REL_L2,
          "rows_compared": keep, "rows_left_out": gen_len + 1 - len(keep),
          "rows_with_a_mesh_drop": int(lost_m.sum()),
          "rows_with_an_unsharded_drop": int(lost_f.sum()),
          "mesh_vs_unsharded": mesh_vs_flat,
          "row_rel_l2": per_row,
          "replay_equals_served": served_equal,
          "decode_attention": {
              "q": list(q.shape), "cache": list(k.shape), "pos": pos,
              "ranks": mesh.shape[plan.tp], "tol": tol,
              "vs_split_decode": vs_kernel,
              "vs_plain": attn_err(got, plain, tol),
              "planted_without_pmax": planted}})
    require(len(keep) >= gen_len + 1 - MESH_DECODE_DROP_ROWS,
            f"serve_mesh: only rows {keep} were dispatched alike")
    require(mesh_vs_flat["rel_l2"] <= KIMI_REL_L2,
            f"serve_mesh: mesh'd vs unsharded logits {mesh_vs_flat}")
    require(vs_kernel["within"],
            f"decode_attention_sharded vs split_decode: {vs_kernel}")
    require(not planted["within"],
            f"a merge without pmax passes: {planted}")
    del q, k, v, attn_in, rows_mesh, rows_flat

    # (e) the long prefill's dispatch buckets through the two-layer
    # all-to-all, (pod 2, ici 8) over the 16 model ranks
    p, x = found.pop("mesh_prefill")
    lay = MS.layout(x.shape, cfg, plan)
    route = MS.sharded_route(p, x, cfg, plan)
    xt = compat.to_ranks(x, lay.ranks, lay.x_spec).reshape(
        *route.eids.shape[:-2], -1, cfg.d_model)
    disp, _ = MS._local_dispatch(xt, route.eids, cfg.moe.num_experts,
                                 lay.cap)
    n = lay.ranks.sizes[-1]
    grid = compat.EmulatedMesh((2, n // 2), ("pod", "ici"))
    R2 = compat.Ranks.of(grid, grid.axis_names)
    buckets = disp.reshape(2, n // 2, n, -1)
    del disp
    flat_ranks = compat.Ranks.of(mesh, (plan.tp,))
    two, two_ms = synced(torch, lambda: H.two_layer_all_to_all(
        buckets, R2, "ici", "pod"))
    equal_two = bool(torch.equal(two.reshape(n, n, -1),
                                 buckets.reshape(n, n, -1).transpose(0, 1)))
    del two
    one, one_ms = synced(torch, lambda: compat.all_to_all(
        buckets.reshape(n, n, -1), flat_ranks, plan.tp, 0, 0, tiled=True))
    equal_one = bool(torch.equal(one,
                                 buckets.reshape(n, n, -1).transpose(0, 1)))
    bucket_bytes = buckets.numel() * buckets.element_size()
    del one, buckets
    emit({"phase": "serve_mesh_all_to_all",
          "buckets": [n, cfg.moe.num_experts, lay.cap, cfg.d_model],
          "bytes": bucket_bytes, "grid": grid.shape,
          "two_layer_equals_flat_transpose": equal_two,
          "two_layer_ms": two_ms,
          "flat_all_to_all_equals_transpose": equal_one,
          "flat_all_to_all_ms": one_ms})
    require(equal_two and equal_one, "two_layer_all_to_all is not the "
            "flat transpose of the dispatch buckets")
    torch.cuda.empty_cache()

    profs = serve_profiles(torch, layers, cfg, params, traffic, "serve_mesh",
                           route_counts(tc_prefill=cfg.n_layers),
                           route_counts(), plan=plan, decode_plan=dplan)
    emit({"phase": "serve_mesh_vs_unsharded", **{
        f"{name}_{what}": {"mesh": profs[what][key],
                           "unsharded": base["profiles"][what][key]}
        for what in ("generate", "prefill", "decode")
        for name, key in (("wall_s", "wall_s"), ("idle_share", "idle_share"),
                          ("device_busy_s", "device_busy_s"))}})
    del traffic
    torch.cuda.empty_cache()
    return traffic_counts(rec_a, rec_b)


def seeded_grads(torch, shape, grid, seed, dev):
    """8 ranks' seeded f32 gradients of one leaf: ``[*grid, *shape]``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randn((*grid, *shape), generator=gen, device=dev)


def two_layer_psum_without_slow(x, ranks, fast, slow):
    """A planted fault: ``two_layer_psum`` with the slow-axis psum left
    out (each pod keeps its own partial sum)."""
    from repro_torch import compat
    from repro_torch.core import hierarchical as H
    shape = x.shape[ranks.n:]
    flat, n = H._flat_padded(x, ranks, compat.axis_size(ranks, fast))
    shard = compat.psum_scatter(flat, ranks, fast, 0)
    return H._unflat(compat.all_gather(shard, ranks, fast, 0), ranks, n,
                     shape)


def phase_collectives(torch, dev):
    """The two-layer gradient sync (``core.hierarchical``) on the
    emulated (pod 2, ici 4) grid: every parameter leaf of
    ``phase_train``'s gemma2-9b (full width, depth 2, f32) as 8 ranks'
    seeded gradients, one leaf at a time (the 256000 x 3584 embedding's
    8 ranks alone take 29.4 GB). Each leaf: ``two_layer_psum`` against a
    plain sum over the rank axes (max |diff| <= ``COLLECTIVE_REL`` x max
    |sum|); ``compressed_psum`` over two steps with the residual fed
    back (relative error < ``EF_BOUND``, residual nonzero:
    ``spmd_checks``' bounds); the tree forms' results equal it leaf by
    leaf on the small leaves. A planted fault, the psum without its
    slow-axis hop, must fail the first check. Prints each form's wall
    time and its slow-hop bytes a rank (1/q of the flat sum's; int8
    a quarter of that, plus a scale), the peak, and a profile of both
    forms on the largest leaf (its idle share)."""
    import dataclasses
    from repro_torch import compat, configs
    from repro_torch._tree import leaves_with_paths
    from repro_torch.core import hierarchical as H
    from repro_torch.models import transformer as T
    free_device(torch, dev)
    cfg = dataclasses.replace(configs.get("gemma2_9b"),
                              n_layers=TRAIN_LAYERS)
    like = T.init_params(0, cfg, dtype=torch.bfloat16, device=dev)
    shapes = [(path, tuple(t.shape)) for path, t in leaves_with_paths(like)]
    del like
    torch.cuda.empty_cache()
    grid = COLLECTIVE_GRID
    ranks = compat.Ranks.of(compat.EmulatedMesh(grid, ("pod", "ici")),
                            ("pod", "ici"))
    q = grid[1]
    worst = {"psum": 0.0, "ef_step1": 0.0, "ef_step2": 0.0}
    walls = {"psum": 0.0, "plain_sum": 0.0, "ef": 0.0}
    planted = []
    elems = 0
    for i, (path, shape) in enumerate(shapes):
        x = seeded_grads(torch, shape, grid, 2 * i, dev)
        want, plain_ms = synced(torch, lambda: x.sum((0, 1)))
        got, ms = synced(torch, lambda: H.two_layer_psum(x, ranks, "ici",
                                                         "pod"))
        scale = float(want.abs().max())
        worst["psum"] = max(worst["psum"], float(
            (got.reshape(shape) - want).abs().max()) / scale)
        walls["psum"] += ms
        walls["plain_sum"] += plain_ms
        del got
        if len(planted) < 2:
            bad = two_layer_psum_without_slow(x, ranks, "ici", "pod")
            planted.append(float((bad - want).abs().max()) / scale)
            del bad
        del want
        res = torch.zeros((), device=dev).expand(x.shape)
        for step in (1, 2):
            if step == 2:          # one leaf's 8 ranks at a time
                del x
                x = seeded_grads(torch, shape, grid, 2 * i + 1, dev)
            (out, res), ms = synced(torch, lambda: H.compressed_psum(
                x, res, ranks, "ici", "pod"))
            walls["ef"] += ms
            want = x.sum((0, 1))
            rel = float((out[0, 0] - want).abs().max()
                        / want.abs().max())
            worst[f"ef_step{step}"] = max(worst[f"ef_step{step}"], rel)
            require(math.prod(shape) <= q or float(res.abs().sum()) > 0,
                    f"{path}: the residual is zero")
            del out, want
        elems += math.prod(shape)
        del x, res
        torch.cuda.empty_cache()
    small = {p: seeded_grads(torch, s, grid, 7, dev) for p, s in shapes
             if math.prod(s) < (1 << 20)}
    tree = H.tree_two_layer_psum(list(small.values()), ranks, "ici", "pod")
    tree_equal = all(torch.equal(t, H.two_layer_psum(x, ranks, "ici", "pod"))
                     for t, x in zip(tree, small.values()))
    del small, tree
    # the idle share: a profile of both forms on the largest leaf
    big = max(range(len(shapes)), key=lambda j: math.prod(shapes[j][1]))
    x = seeded_grads(torch, shapes[big][1], grid, 2 * big, dev)

    def both():
        H.two_layer_psum(x, ranks, "ici", "pod")
        H.compressed_psum(x, torch.zeros((), device=dev).expand(x.shape),
                          ranks, "ici", "pod")
    prof = profile_write(torch, both, ())
    del x
    torch.cuda.empty_cache()
    flat_bytes = 4 * elems
    rec = {"config": cfg.name, "layers": cfg.n_layers, "leaves": len(shapes),
           "elements_a_rank": elems, "grid": dict(zip(ranks.names,
                                                     ranks.sizes)),
           "largest_leaf_bytes_8_ranks": 4 * 8 * max(
               math.prod(s) for _, s in shapes),
           "psum_max_rel": worst["psum"], "psum_bound": COLLECTIVE_REL,
           "ef_max_rel": [worst["ef_step1"], worst["ef_step2"]],
           "ef_bound": EF_BOUND,
           "planted_no_slow_hop_rel": planted,
           "tree_forms_equal_leaf_loop": tree_equal,
           "wall_ms": walls,
           "profile_largest_leaf": {"leaf": shapes[big][0], **{
               k: prof[k] for k in ("wall_s", "device_busy_s", "idle_share",
                                    "device_ops", "top_ops")}},
           "slow_hop_bytes_a_rank": {"flat_psum": flat_bytes,
                                     "two_layer": flat_bytes // q,
                                     "compressed": elems // q + 4 * len(
                                         shapes)},
           "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    emit({"phase": "collectives", **rec})
    require(worst["psum"] <= COLLECTIVE_REL, f"two_layer_psum: {rec}")
    require(max(worst["ef_step1"], worst["ef_step2"]) < EF_BOUND,
            f"compressed_psum: {rec}")
    require(min(planted) > COLLECTIVE_REL,
            f"a psum without the slow hop passes: {rec}")
    require(tree_equal, "tree_two_layer_psum differs from the leaf loop")
    torch.cuda.empty_cache()


def phase_pipeline(torch, dev):
    """``models.pipeline.pipeline_apply`` on an emulated ``pipe`` axis of
    4 stages, each one super-block of gemma2-9b at full width (a local
    and a global layer, bf16, seeded: 8 layers), over 8 microbatches of
    ``[1, 4096]`` token embeddings. Its output must equal sequential
    application of the 4 blocks bit for bit (the same calls on the same
    rows; each stage's attention on ``tc_prefill``). Prints both walls
    (S + M - 1 = 11 rounds of 4 stage calls, 44 calls against 32), the
    peak, a profile of the pipeline (its idle share) and its flash
    launches, which its counted run takes."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.compat import EmulatedMesh
    from repro_torch.models import transformer as T
    from repro_torch.models.pipeline import pipeline_apply
    free_device(torch, dev)
    n_stages, n_mb, seq = MESH_PIPE
    cfg = dataclasses.replace(configs.get("gemma2_9b"),
                              n_layers=n_stages * 2)
    params = T.init_params(0, cfg, dtype=torch.bfloat16, device=dev)
    stage_params = params["blocks"]["slots"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (n_mb, seq), generator=gen,
                           device=dev)
    x = T._embed_inputs(params, cfg, {"tokens": tokens})
    positions = T._positions(1, seq, dev)
    calls = []

    def stage_fn(p, xb):
        calls.append(1)
        blocks = {"slots": [{k: _lead(v) for k, v in slot.items()}
                            for slot in p]}
        return T._run_blocks(blocks, xb, cfg, positions)[0]

    def sequential():
        outs = []
        for m in range(n_mb):
            y = x[m:m + 1]
            for s in range(n_stages):
                y = stage_fn([_index(slot, s) for slot in stage_params], y)
            outs.append(y)
        return torch.cat(outs)
    run = pipeline_apply(stage_fn, EmulatedMesh((n_stages,), ("pipe",)),
                         microbatches=n_mb)
    run(stage_params, x)                                     # warm-up
    sequential()
    calls.clear()
    out, ms, launches, routes, peak = counted(
        torch, dev, lambda: run(stage_params, x))
    pipe_calls = len(calls)
    calls.clear()
    prof = profile_write(torch, run, (stage_params, x))
    calls.clear()
    want, seq_ms = synced(torch, sequential)
    rel = float((out.float() - want.float()).norm() / want.float().norm())
    rec = {"stages": n_stages, "microbatches": n_mb, "tokens": seq,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "stage_param_bytes": sum(t.numel() * t.element_size()
                                    for t in _leaves(stage_params)),
           "pipeline_ms": ms, "sequential_ms": seq_ms,
           "ratio": ms / seq_ms, "stage_calls": pipe_calls,
           "sequential_calls": len(calls), "bit_equal": bool(
               torch.equal(out, want)), "rel_l2": rel,
           "peak_mem_bytes": peak, "launches": launches,
           "flash_launches_by_route": routes,
           "profile": {k: prof[k] for k in ("wall_s", "device_busy_s",
                                            "idle_share", "device_ops",
                                            "top_ops")}}
    emit({"phase": "pipeline", **rec})
    require(pipe_calls == n_stages * (n_stages + n_mb - 1),
            f"pipeline: {pipe_calls} stage calls")
    require(rec["bit_equal"], f"pipeline vs sequential: {rec}")
    require(routes == route_counts(tc_prefill=2 * pipe_calls),
            f"pipeline: flash routes {routes}")
    del params, stage_params, x, out, want
    torch.cuda.empty_cache()
    return launches, routes


def _lead(tree):
    """A stage's parameter slice with the stacked blocks' axis put back
    (one block)."""
    if isinstance(tree, dict):
        return {k: _lead(v) for k, v in tree.items()}
    return tree[None]


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def phase_serve_ssm(torch, dev):
    """Greedy serving of mamba2-2.7b (ssm) whole: 64 Mamba2 layers at
    d 2560 (d_inner 5120, 80 heads of 64, d_state 128, conv 4, SSD
    chunks of 256), vocab 50280, bf16 weights from a seeded
    ``torch.Generator``; the traffic of ``phase_serve``
    (``serve_traffic``). The model is attention-free: this path launches
    no kernel of the port (the projections are cuBLAS products, the SSD
    scan and the conv plain PyTorch), which the run requires.

    Checks, each failing the run: the served logits against
    teacher-forced ``forward`` logits of the same tokens, relative L2
    within ``SERVE_REL_L2`` (the forward runs over the 8208 tokens
    followed by tokens up to a multiple of the SSD chunk, which a causal
    model's earlier rows never see); a planted fault, the same decode
    steps after a prefill whose SSM states were zeroed, must exceed that
    limit; and the decode state's shapes do not depend on the history
    (``init_decode_state`` at 8 and at 8208 positions, and the long
    prefill's state, as ``tests/test_models.py`` holds the reference)."""
    from repro_torch import configs
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    cfg = configs.get("mamba2_27b")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = T.init_params(0, cfg, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    mc = cfg.mamba
    emit({"phase": "serve_ssm_setup", **param_record(cfg, params),
          "d_inner": mc.d_inner(cfg.d_model),
          "ssm_heads": [mc.n_heads(cfg.d_model), mc.head_dim],
          "d_state": mc.d_state, "d_conv": mc.d_conv, "chunk": mc.chunk,
          "cut": "none (full width and depth)",
          "init_s": time.perf_counter() - t0})
    traffic = serve_traffic(torch, dev, cfg, params)
    rec_a, rec_b = traffic["records"]
    note = ("no TPU kernel on this path: the model is attention-free "
            "(cuBLAS projections, plain-PyTorch SSD scan and conv)")
    for rec in (rec_a, rec_b):
        emit({"phase": "serve_ssm", **rec, "kernels": note})
        require(sum(rec["launches"].values()) == 0,
                f"serve_ssm {rec['run']}: launched {rec['launches']}")
    gen_len, plen = GEN[2], LONG_PROMPT

    full = torch.cat([traffic["prompt"], traffic["picked"]], dim=1)
    pad = -full.shape[1] % mc.chunk
    fwd, _ = T.forward(params, cfg, {"tokens": torch.cat(
        [full, full[:, :pad]], dim=1)})
    dec_vs_fwd = {**logit_stats(torch, traffic["served"],
                                fwd[:, plen - 1:plen + gen_len]),
                  "rows_rel_l2": row_rel_l2(traffic["served"],
                                            fwd[:, plen - 1:plen + gen_len])}
    del fwd
    _, state = T.prefill(params, cfg, {"tokens": traffic["prompt"]})
    for c in state.ssm:
        if c is not None:
            c[0].zero_()                           # the planted fault
    rows = []
    for t in range(gen_len):
        logits, state = T.decode_step(params, cfg, state,
                                      traffic["picked"][:, t])
        rows.append(logits)
    planted_rows = torch.stack(rows, dim=1)
    planted = {**logit_stats(torch, planted_rows, traffic["served"][:, 1:]),
               "rows_rel_l2": row_rel_l2(planted_rows,
                                         traffic["served"][:, 1:])}
    long_shapes = [tuple(x.shape[2:]) for c in state.ssm for x in c]
    del state, rows

    def shapes(max_seq):
        st = T.init_decode_state(cfg, 1, max_seq, device=dev)
        return [tuple(x.shape[2:]) for c in st.ssm for x in c]
    invariant = shapes(8) == shapes(plen + gen_len) == long_shapes
    emit({"phase": "serve_ssm_checks", "tokens": list(full.shape),
          "forward_tokens": full.shape[1] + pad,
          "tol_rel_l2": SERVE_REL_L2, "decode_vs_forward": dec_vs_fwd,
          "planted_ssm_state_zeroed_vs_served": planted,
          "state_shapes": long_shapes,
          "state_shapes_history_invariant": invariant})
    require(dec_vs_fwd["rel_l2"] <= SERVE_REL_L2,
            f"serve_ssm decode vs forward logits: {dec_vs_fwd}")
    require(planted["rows_rel_l2"][0] > SERVE_REL_L2,
            f"serve_ssm: a decode without its SSM state passes: {planted}")
    require(invariant, "serve_ssm: the decode state's shapes depend on the "
            "history")
    torch.cuda.empty_cache()
    serve_profiles(torch, layers, cfg, params, traffic, "serve_ssm",
                   route_counts(), route_counts())
    del params, traffic
    torch.cuda.empty_cache()
    return traffic_counts(rec_a, rec_b)


# serving of the vlm and audio families (llava-next-34b, whisper-tiny)
AUDIO_REL_L2 = 1e-2           # whisper's 4 decoder layers, f32 weights
# the same in bf16: bf16's own distance from the f32 weights' logits is
# 0.0117 on whisper-tiny (an H100 SXM at 700 W; the per-layer attention
# checks read 1.2e-3 at most), and two bf16 computations in other orders
# may each be that far: twice it, rounded up
AUDIO_BF16_REL_L2 = 2.5e-2
AUDIO_LONG = (32, 448)        # whisper's long request: 1 x 32 + 448


def free_device(torch, dev) -> int:
    """Drop what earlier phases left (``gc``, the caching allocator's
    free blocks), reset the peak statistics; the bytes still allocated."""
    import gc
    torch.cuda.synchronize(dev)      # initialises CUDA in a fresh process
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def as_f32(tree):
    """A parameter tree with every leaf converted to f32 (exactly, from
    bf16)."""
    if isinstance(tree, dict):
        return {k: as_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_f32(v) for v in tree]
    return tree.float()


def decode_rows(torch, params, cfg, state, picked):
    """Teacher-forced decode of ``picked`` [B, n] from ``state`` (grown
    by n): the logit rows ``[B, n, V]``."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    state = serve._grow_caches(state, picked.shape[1])
    rows = []
    for t in range(picked.shape[1]):
        logits, state = T.decode_step(params, cfg, state, picked[:, t])
        rows.append(logits)
    return torch.stack(rows, dim=1)


def phase_serve_vlm(torch, dev):
    """Greedy serving of llava-next-34b (vlm) at full width and depth
    (60 layers): d 7168, 56 query over 8 kv heads of 128 (g = 7),
    d_ff 20480, vocab 64000, 576 image prefix rows (the reference's
    vision stub: precomputed embeddings, here seeded normal at the token
    embeddings' scale, 0.02 sqrt(d)); bf16 weights from a seeded
    ``torch.Generator`` (68.78 GB at depth 60). Traffic: (a)
    ``serve.generate`` 4 x 32 + 16 on tokens alone, as the reference CLI
    serves it; (b) a long prompt of 576 prefix rows + 8192 tokens and 16
    decode steps (``serve_traffic``); (c) an image-prefixed request:
    batch 4, 576 prefix rows + 32 tokens, 16 decode steps
    (``served_request``), the reference's own drive of a vlm
    (``tests/test_models.py``). Every prefill layer on ``tc_prefill``,
    every decode layer on ``split_decode`` (required per run).

    Checks, each failing the run: (c)'s served logits (the prefill's
    last row, each decode step's) against a teacher-forced ``forward`` of
    the same prefix and tokens, and so (b)'s, relative L2 within
    ``SERVE_REL_L2``; (c)'s ``forward`` and prefill through the kernels
    against attention forced through ``flash_attention_ref``, within the
    same limit, where a forward without the causal mask must not be; the
    first layer's attention of (c)'s prefill against the plain version
    (``layer_checks``); and a planted fault: (c)'s decode steps after a
    prefill whose prefix KV rows (positions 0 to 575) were zeroed must
    fail the decode check. The long prompt's attention against the plain
    version is ``phase_flash``'s ``llava_prefill`` case (the plain
    version's 8 GB f32 logits a chunk do not fit beside the weights).
    Returns the launches and flash routes of the three counted runs."""
    from repro_torch import configs, kernels
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    cfg = configs.get("llava_next_34b")
    resident = free_device(torch, dev)
    t0 = time.perf_counter()
    params = T.init_params(0, cfg, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    npfx, d = cfg.num_prefix_embeds, cfg.d_model
    emit({"phase": "serve_vlm_setup", **param_record(cfg, params),
          "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
          "d_ff": cfg.d_ff, "prefix_rows": npfx,
          "cut": "none (full width and depth)",
          "resident_before_bytes": resident,
          "init_s": time.perf_counter() - t0})
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def prefix(b):
        return torch.randn((b, npfx, d), generator=gen, device=dev).mul_(
            0.02 * math.sqrt(d))
    traffic = serve_traffic(torch, dev, cfg, params,
                            long_extra={"prefix_embeds": prefix(1)})
    batch, plen, gen_len = GEN
    img = {"tokens": torch.randint(0, cfg.vocab, (batch, plen),
                                   generator=gen, device=dev,
                                   dtype=torch.int32),
           "prefix_embeds": prefix(batch)}
    captured = {}

    def watch():
        return patched_attention(layers, watching(
            lambda q, k, v, kw: captured.setdefault("global", (q, k, v, kw))))

    def checks():
        layer_checks(ops, ref, captured, "serve_vlm_layer_checks",
                     ("global",))
        captured.clear()
    rec_c, picked_c, served_c = served_request(
        torch, dev, cfg, params, img, gen_len, "image_request", watch, checks)
    rec_a, rec_b = traffic["records"]
    per_run = route_counts(tc_prefill=cfg.n_layers,
                     split_decode=gen_len * cfg.n_layers)
    for rec in (rec_a, rec_b, rec_c):
        emit({"phase": "serve_vlm", **rec})
        require(rec["flash_launches_by_route"] == per_run,
                f"serve_vlm {rec['run']}: flash routes "
                f"{rec['flash_launches_by_route']}, expected {per_run}")

    # (c): decode and prefill vs forward, kernel vs plain, planted faults
    full = {"tokens": torch.cat([img["tokens"], picked_c], dim=1),
            "prefix_embeds": img["prefix_embeds"]}
    rows = slice(npfx + plen - 1, npfx + plen + gen_len)
    fwd, _ = T.forward(params, cfg, full)
    dec_vs_fwd = logit_stats(torch, served_c, fwd[:, rows])
    before = kernels.launch_counts()["flash_attention_fused"]
    with patched_attention(layers, lambda _: ref.flash_attention_ref):
        fwd_plain, _ = T.forward(params, cfg, full)
        prefill_plain, _ = T.prefill(params, cfg, img)
    require(kernels.launch_counts()["flash_attention_fused"] == before,
            "the plain-attention runs launched the kernel")
    kern_vs_plain = logit_stats(torch, fwd, fwd_plain)
    prefill_vs_plain = logit_stats(torch, served_c[:, :1],
                                   prefill_plain[:, None])
    del fwd_plain, prefill_plain
    with patched_attention(layers, without_causal):
        fwd_planted, _ = T.forward(params, cfg, full)
    causal_vs_kern = logit_stats(torch, fwd_planted, fwd)
    del fwd, fwd_planted
    _, state = T.prefill(params, cfg, img)
    for k_cache, v_cache in state.kv:
        k_cache[:, :, :npfx].zero_()                # the planted fault
        v_cache[:, :, :npfx].zero_()
    planted_rows = decode_rows(torch, params, cfg, state, picked_c)
    del state
    prefix_zeroed = logit_stats(torch, planted_rows, served_c[:, 1:])
    del planted_rows

    # (b): the long prompt's decode vs forward
    long_full = {"tokens": torch.cat([traffic["prompt"], traffic["picked"]],
                                     dim=1),
                 "prefix_embeds": traffic["long_batch"]["prefix_embeds"]}
    fwd, _ = T.forward(params, cfg, long_full)
    end = npfx + long_full["tokens"].shape[1]
    long_dec_vs_fwd = logit_stats(torch, traffic["served"],
                                  fwd[:, end - gen_len - 1:end])
    del fwd
    emit({"phase": "serve_vlm_checks", "tol_rel_l2": SERVE_REL_L2,
          "image_request": {"batch": batch, "prefix_rows": npfx,
                            "tokens": plen + gen_len},
          "decode_vs_forward": dec_vs_fwd,
          "forward_kernel_vs_plain": kern_vs_plain,
          "prefill_kernel_vs_plain": prefill_vs_plain,
          "planted_causal_dropped_vs_kernel": causal_vs_kern,
          "planted_prefix_kv_zeroed_vs_served": prefix_zeroed,
          "long_prompt_decode_vs_forward": long_dec_vs_fwd})
    for what, st in (("decode vs forward", dec_vs_fwd),
                     ("forward through the kernel vs plain", kern_vs_plain),
                     ("prefill through the kernel vs plain",
                      prefill_vs_plain),
                     ("long prompt decode vs forward", long_dec_vs_fwd)):
        require(st["rel_l2"] <= SERVE_REL_L2, f"serve_vlm {what}: {st}")
    for what, st in (("a forward without the causal mask", causal_vs_kern),
                     ("a decode after the prefix's KV rows were zeroed",
                      prefix_zeroed)):
        require(st["rel_l2"] > SERVE_REL_L2, f"serve_vlm: {what} passes: "
                f"{st}")
    torch.cuda.empty_cache()
    serve_profiles(torch, layers, cfg, params, traffic, "serve_vlm",
                   route_counts(tc_prefill=cfg.n_layers),
                   route_counts(split_decode=gen_len * cfg.n_layers))
    del params, traffic, img, full, long_full
    torch.cuda.empty_cache()
    counts = traffic_counts(rec_a, rec_b)
    return (add_routes(counts[0], rec_c["launches"]),
            add_routes(counts[1], rec_c["flash_launches_by_route"]))


def encoder_causal(enc_seq):
    """A planted fault: the encoder's self-attention (non-causal, Sq =
    Skv = ``enc_seq``, no ``kv_len``) run causal."""
    def wrap(attention):
        def run(q, k, v, **kw):
            if (not kw["causal"] and kw.get("kv_len") is None
                    and q.shape[1] == k.shape[1] == enc_seq):
                kw = {**kw, "causal": True}
            return attention(q, k, v, **kw)
        return run
    return wrap


def phase_serve_audio(torch, dev):
    """Greedy serving of whisper-tiny (enc-dec audio) whole: 4 encoder
    and 4 decoder layers, d 384, 6 heads of 64, d_ff 1536, vocab 51865,
    1500 frames (the reference's audio stub: precomputed frame
    embeddings); bf16 weights from a seeded ``torch.Generator``. Traffic
    (``serve_traffic``): (a) ``serve.generate`` 4 x 32 + 16 with the
    reference CLI's frames (f32, all 0.01); (b) a long decode, 1 x 32 +
    448 on seeded unit-normal f32 frames (constant frames make every
    encoder row equal and would hide a mask or key-range fault). As in
    the reference, f32 frames against bf16 weights run the encoder in
    f32 (``tc_f32``, non-causal), the decoder in bf16 (self-attention on
    ``tc_prefill`` and ``split_decode``) and its cross-attention in f32
    (``tc_f32``: bf16 queries promoted against f32 keys); every count by
    route is required per run.

    Checks, each failing the run, on (b): decode against a
    teacher-forced ``forward`` of the same frames and tokens, and
    ``forward`` and the prefill through the kernels against attention
    forced through ``flash_attention_ref``, relative L2 within
    ``AUDIO_BF16_REL_L2``, and the bf16 forward against the same weights
    converted to f32 within it too; the f32 model's decode against its
    forward, and its forward through the kernels against the plain
    attention, within ``AUDIO_REL_L2``; the encoder outputs through the
    kernels and the plain attention within ``ATTN_TOL``; the attention of the first encoder layer, the first
    decoder self-attention and the first cross-attention against the
    plain version (``layer_checks``); the encoder output in f32, the KV
    caches and logits in bf16; planted faults: the encoder run causal
    must fail the encoder-output check, and decode steps from a state
    whose ``enc_out`` was zeroed must fail the decode check. Returns the
    launches and flash routes of the two counted runs."""
    from repro_torch import configs, kernels
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    cfg = configs.get("whisper_tiny")
    resident = free_device(torch, dev)
    t0 = time.perf_counter()
    params = T.init_params(0, cfg, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    emit({"phase": "serve_audio_setup", **param_record(cfg, params),
          "enc_layers": cfg.n_enc_layers, "enc_seq": cfg.enc_seq,
          "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
          "d_ff": cfg.d_ff, "cut": "none (whole)",
          "resident_before_bytes": resident,
          "init_s": time.perf_counter() - t0})
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    frames = torch.randn((1, cfg.enc_seq, cfg.d_model), generator=gen,
                         device=dev)
    captured = {}

    def kind(q, k, kw):
        if kw["causal"]:
            return "decoder_self"
        return "encoder" if q.shape[1] == k.shape[1] else "cross"

    def watch():
        return patched_attention(layers, watching(
            lambda q, k, v, kw: captured.setdefault(kind(q, k, kw),
                                                    (q, k, v, kw))))

    def checks():
        layer_checks(ops, ref, captured, "serve_audio_layer_checks",
                     ("cross", "decoder_self", "encoder"))
        captured.clear()
    plen, long_gen = AUDIO_LONG
    traffic = serve_traffic(torch, dev, cfg, params, watch, checks,
                            long_extra={"frames": frames}, long_len=plen,
                            long_gen=long_gen)
    rec_a, rec_b = traffic["records"]
    n, gen_len = cfg.n_layers, GEN[2]
    for rec, steps in ((rec_a, gen_len), (rec_b, long_gen)):
        emit({"phase": "serve_audio", **rec})
        want = route_counts(tc_prefill=n, split_decode=steps * n,
                      tc_f32=cfg.n_enc_layers + n + steps * n)
        require(rec["flash_launches_by_route"] == want,
                f"serve_audio {rec['run']}: flash routes "
                f"{rec['flash_launches_by_route']}, expected {want}")

    batch = traffic["long_batch"]
    full = {"tokens": torch.cat([traffic["prompt"], traffic["picked"]],
                                dim=1), "frames": frames}
    rows = slice(plen - 1, plen + long_gen)
    fwd, _ = T.forward(params, cfg, full)
    dec_vs_fwd = {**logit_stats(torch, traffic["served"], fwd[:, rows]),
                  "rows_rel_l2_max": max(row_rel_l2(traffic["served"],
                                                    fwd[:, rows]))}
    _, state = T.prefill(params, cfg, batch)
    types = {"enc_out": str(state.enc_out.dtype),
             "kv": str(state.kv[0][0].dtype),
             "logits": str(traffic["served"].dtype)}
    enc_out = state.enc_out
    before = kernels.launch_counts()["flash_attention_fused"]
    with patched_attention(layers, lambda _: ref.flash_attention_ref):
        fwd_plain, _ = T.forward(params, cfg, full)
        prefill_plain, state_plain = T.prefill(params, cfg, batch)
    require(kernels.launch_counts()["flash_attention_fused"] == before,
            "the plain-attention runs launched the kernel")
    kern_vs_plain = logit_stats(torch, fwd, fwd_plain)
    prefill_vs_plain = logit_stats(torch, traffic["served"][:, :1],
                                   prefill_plain[:, None])
    enc_vs_plain = attn_err(enc_out, state_plain.enc_out,
                            ATTN_TOL["float32"])
    del fwd_plain, prefill_plain, state_plain
    with patched_attention(layers, encoder_causal(cfg.enc_seq)):
        _, state_planted = T.prefill(params, cfg, batch)
        fwd_causal_enc, _ = T.forward(params, cfg, full)
    enc_causal = attn_err(state_planted.enc_out, enc_out,
                          ATTN_TOL["float32"])
    enc_causal_logits = logit_stats(torch, fwd_causal_enc, fwd)
    del state_planted, fwd_causal_enc
    state = state._replace(enc_out=torch.zeros_like(enc_out))
    planted_rows = decode_rows(torch, params, cfg, state, traffic["picked"])
    enc_zeroed = logit_stats(torch, planted_rows, traffic["served"][:, 1:])
    del state, planted_rows

    # the same weights in f32 (exactly), the same frames and tokens: the
    # bf16 path's distance from them, and the f32 model's own checks
    p32 = as_f32(params)
    fwd32, _ = T.forward(p32, cfg, full)
    bf16_vs_f32 = logit_stats(torch, fwd, fwd32)
    logits32, st32 = T.prefill(p32, cfg, batch)
    served32 = torch.cat([logits32[:, None], decode_rows(
        torch, p32, cfg, st32, traffic["picked"])], dim=1)
    del st32
    dec_vs_fwd32 = logit_stats(torch, served32, fwd32[:, rows])
    with patched_attention(layers, lambda _: ref.flash_attention_ref):
        fwd32_plain, _ = T.forward(p32, cfg, full)
    kern_vs_plain32 = logit_stats(torch, fwd32, fwd32_plain)
    del p32, fwd32, fwd32_plain, served32, fwd
    emit({"phase": "serve_audio_checks", "tol_rel_l2": AUDIO_REL_L2,
          "tol_rel_l2_bf16": AUDIO_BF16_REL_L2,
          "tokens": list(full["tokens"].shape), "frames": "seeded normal",
          "types": types, "decode_vs_forward": dec_vs_fwd,
          "forward_kernel_vs_plain": kern_vs_plain,
          "prefill_kernel_vs_plain": prefill_vs_plain,
          "forward_bf16_vs_f32_weights": bf16_vs_f32,
          "f32_decode_vs_forward": dec_vs_fwd32,
          "f32_forward_kernel_vs_plain": kern_vs_plain32,
          "encoder_output_kernel_vs_plain": enc_vs_plain,
          "planted_encoder_causal_output": enc_causal,
          "planted_encoder_causal_logits_vs_kernel": enc_causal_logits,
          "planted_enc_out_zeroed_vs_served": enc_zeroed})
    require(types == {"enc_out": "torch.float32", "kv": "torch.bfloat16",
                      "logits": "torch.bfloat16"},
            f"serve_audio: types {types}, not the reference's")
    for what, st, tol in (
            ("f32 decode vs forward", dec_vs_fwd32, AUDIO_REL_L2),
            ("f32 forward through the kernel vs plain", kern_vs_plain32,
             AUDIO_REL_L2),
            ("decode vs forward", dec_vs_fwd, AUDIO_BF16_REL_L2),
            ("forward through the kernel vs plain", kern_vs_plain,
             AUDIO_BF16_REL_L2),
            ("prefill through the kernel vs plain", prefill_vs_plain,
             AUDIO_BF16_REL_L2),
            ("the bf16 forward vs the f32 weights'", bf16_vs_f32,
             AUDIO_BF16_REL_L2)):
        require(st["rel_l2"] <= tol, f"serve_audio {what}: {st}")
    require(enc_vs_plain["within"],
            f"serve_audio: the encoder output through the kernel vs plain: "
            f"{enc_vs_plain}")
    require(not enc_causal["within"],
            f"serve_audio: a causal encoder passes: {enc_causal}")
    require(enc_zeroed["rel_l2"] > AUDIO_BF16_REL_L2,
            f"serve_audio: a decode without the encoder output passes: "
            f"{enc_zeroed}")
    torch.cuda.empty_cache()
    serve_profiles(torch, layers, cfg, params, traffic, "serve_audio",
                   route_counts(tc_prefill=n, tc_f32=cfg.n_enc_layers + n),
                   route_counts(split_decode=gen_len * n, tc_f32=gen_len * n))
    del params, traffic, frames, full, enc_out
    torch.cuda.empty_cache()
    return traffic_counts(rec_a, rec_b)


def phase_serve_restore(torch, dev, trained):
    """Serving from the training phase's newest checkpoint (the step-4
    state of the resumed run): ``serve.restore_params`` on the serving
    host layout (8 readers on 2 nodes, the manifest's striping) reads
    the whole state ``{"params", "opt"}`` through the planned collective
    read, once with the node cache and once without; then
    ``serve.generate`` (4 x 32 + 16, the f32 gemma2 at the training
    phase's depth, every attention on ``tc_f32``) from each restore's
    parameters. Checks: each restored state's device digest equals the
    digest of the state that save wrote, the step is the save's, and the
    tokens of both restores equal those generated from the state the run
    ended with. Prints each restore's wall, peak memory and every
    ``IOTimings`` field. The restore launches no kernel of the port (the
    read gathers its windows by spans; ``pack`` builds the images of a
    save); its launches are the generates' attention. Returns them and
    their routes."""
    from repro_torch import kernels
    from repro_torch.kernels import flash
    from repro_torch.launch import serve
    cfg, batch, plen, gen_len = trained["cfg"], *GEN
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (batch, plen), generator=gen,
                            device=dev, dtype=torch.int32)
    serve.generate(trained["params"], cfg, prompts, gen_len)   # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    want = serve.generate(trained["params"], cfg, prompts, gen_len)
    del trained["params"]
    torch.cuda.empty_cache()
    runs = []
    for node_cache in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state, step, timings = serve.restore_params(
            trained["dir"], trained["like"], node_cache=node_cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        equal = state_digest(torch, state) == trained["digest"]
        got = serve.generate(state["params"], cfg, prompts, gen_len)
        runs.append({"node_cache": node_cache, "step": step,
                     "wall_s": wall, "peak_mem_bytes": peak,
                     "restored_equals_saved": equal,
                     "tokens_equal_saved_state": bool(torch.equal(got,
                                                                  want)),
                     "timings": timings_dict(timings)})
        del state, got
        torch.cuda.empty_cache()
    launches = kernels.launch_counts()
    routes = dict(flash.flash_attention_fused.launches_by_route)
    emit({"phase": "serve_restore", "config": cfg.name,
          "layers": cfg.n_layers, "param_dtype": "float32",
          "checkpoint_step": trained["step"], "readers": [8, 2],
          "batch": batch, "prompt_len": plen, "new_tokens": gen_len,
          "restores": runs, "sample": want[0, :8].tolist(),
          "launches": launches, "flash_launches_by_route": routes})
    for r in runs:
        require(r["step"] == trained["step"] and r["restored_equals_saved"],
                f"serve_restore: the restored state differs: {r}")
        require(r["tokens_equal_saved_state"],
                f"serve_restore: generate's tokens differ: {r}")
    require(routes["tc_f32"] == launches["flash_attention_fused"] > 0,
            f"serve_restore: attention off the tc_f32 route: {routes}")
    return launches, routes


def run_measured(torch, dev, fn, args):
    """One warm-up run of ``fn(*args)``, then a timed run with every
    launch count set to 0 just before it and read just after. Returns
    ``(output, record)`` (wall, peak device memory, launches)."""
    from repro_torch import kernels
    fn(*args)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return out, {"wall_s": wall,
                 "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
                 "launches": kernels.launch_counts()}


def phase_patterns(torch, dev, nodes=16, per_node=64, e3sm_reqs=1024,
                   pages=256, rounds=32):
    """The paper's communication-bound pattern and the sparse-checkpoint
    pattern on the BTIO cells' mesh (16 nodes x 64 ranks, one global
    aggregator a node, 32 rounds): E3SM-G (``e3sm_g_pattern``: 1024
    interleaved requests of 512 B a rank, rank r's k-th at slot k*P + r,
    seed 0; 128 int32 elements a request, a 512 MiB file) through the
    two-phase and the TAM write; ``sparse_checkpoint_pattern`` (256 pages
    of 2048 B a rank, 75% all-zero pages, seed 7; uint8 elements, a
    512 MiB file) through the TAM write with ``slow_hop_codec="rle"``,
    and its TAM rle read. Every file equals ``write_reference`` byte for
    byte with zero drops, the two E3SM files are equal, and the read
    returns every rank's payload. Returns the launches of the runs. The
    keyword sizes are the deployment's; a CPU rehearsal shrinks them."""
    import numpy as np

    from repro_torch.core import (IOConfig, RankMesh, contiguous_layout,
                                  make_tam_read, make_tam_write,
                                  make_twophase_write, requests_from_numpy,
                                  write_reference)
    from repro_torch.io_patterns.generators import (
        e3sm_g_pattern, rank_requests_to_elements, sparse_checkpoint_pattern)
    n_nodes, n_ranks = nodes, nodes * per_node
    mesh = RankMesh(n_nodes, 1, per_node)
    t0 = time.perf_counter()
    O, L, C, D = rank_requests_to_elements(
        e3sm_g_pattern(n_ranks, reqs_per_rank=e3sm_reqs, req_bytes=512,
                       seed=0), np.int32)
    layout = contiguous_layout(n_ranks * e3sm_reqs * 128, n_nodes)
    ref = write_reference(layout, O, L, C, D)
    # the BTIO cells' config (262144-element windows: 32 rounds) at 1024
    # requests a rank
    cfg = IOConfig(req_cap=e3sm_reqs, data_cap=D.shape[1], coalesce_cap=512,
                   cb_buffer_size=layout.file_len // n_nodes // rounds,
                   kernel_fusion="fused_round")
    SO, SL, SC, SD = rank_requests_to_elements(
        sparse_checkpoint_pattern(n_ranks, pages_per_rank=pages,
                                  page_bytes=2048, zero_page_fraction=0.75,
                                  seed=7), np.uint8)
    s_layout = contiguous_layout(n_ranks * pages * 2048, n_nodes)
    s_ref = write_reference(s_layout, SO, SL, SC, SD)
    # uint8 elements: 1 MiB windows (the BTIO cells' 262144 int32) keep
    # the 32 rounds
    s_cfg = IOConfig(req_cap=pages, data_cap=SD.shape[1], coalesce_cap=512,
                     cb_buffer_size=s_layout.file_len // n_nodes // rounds,
                     kernel_fusion="fused_round", slow_hop_codec="rle")
    inputs = requests_from_numpy(O, L, C, D, device=dev)
    s_inputs = requests_from_numpy(SO, SL, SC, SD, device=dev)
    writes = {
        "e3sm_g_twophase": (make_twophase_write(mesh, layout, cfg,
                                                device=dev), inputs, ref),
        "e3sm_g_tam": (make_tam_write(mesh, layout, cfg, use_kernels=True,
                                      device=dev), inputs, ref),
        "sparse_ckpt_tam_rle": (make_tam_write(mesh, s_layout, s_cfg,
                                               use_kernels=True, device=dev),
                                s_inputs, s_ref),
    }
    emit({"phase": "patterns_deployment", "ranks": n_ranks,
          "nodes": n_nodes, "ranks_per_node": per_node,
          "e3sm_g": {"requests_per_rank": e3sm_reqs, "request_bytes": 512,
                     "file_bytes": ref.nbytes, "elem": "int32"},
          "sparse_ckpt": {"pages_per_rank": pages, "page_bytes": 2048,
                          "zero_page_fraction": 0.75,
                          "zero_bytes": float((s_ref == 0).mean()),
                          "file_bytes": s_ref.nbytes, "elem": "uint8"},
          "rounds": {k: w[0].plan.n_rounds for k, w in writes.items()},
          "cb": {k: w[0].plan.cb for k, w in writes.items()},
          "setup_s": time.perf_counter() - t0})
    launches, files, runs = {}, {}, {}
    for name, (w, args, want) in writes.items():
        (f, stats), rec = run_measured(torch, dev, w, args)
        launches[name] = rec["launches"]
        runs[name] = (w, args)
        stats = {k: v.cpu().tolist() for k, v in stats.items()}
        files[name] = f.cpu().numpy().reshape(-1)
        require(files[name].tobytes() == want.tobytes(),
                f"{name}: file != write_reference")
        total = {k: sum(v) if isinstance(v, list) else v
                 for k, v in stats.items()}
        drops = {k: v for k, v in total.items() if k.startswith("dropped")}
        require(all(v == 0 for v in drops.values()), f"{name}: drops {drops}")
        extra = {k: total[k] for k in ("requests_before_coalesce",
                                       "requests_after_coalesce")
                 if k in total}
        emit({"phase": "main_path", "method": name, "direction": "write",
              **rec, "file_equals_reference": True, "drops": drops,
              **extra, "requests_at_ga": stats["requests_at_ga"]})
        if name == "sparse_ckpt_tam_rle":
            s_file = f
        del f
    require(files["e3sm_g_twophase"].tobytes()
            == files["e3sm_g_tam"].tobytes(),
            "e3sm_g_twophase file != e3sm_g_tam file")
    read = make_tam_read(mesh, s_layout, s_cfg, device=dev)
    live = (torch.arange(SD.shape[1], device=dev)
            < s_inputs[1].to(torch.int64).sum(dim=1, keepdim=True))
    want = torch.where(live, s_inputs[3], 0)
    got, rec = run_measured(torch, dev, read, (*s_inputs[:3], s_file))
    launches["sparse_ckpt_tam_rle_read"] = rec["launches"]
    runs["sparse_ckpt_tam_rle_read"] = (read, (*s_inputs[:3], s_file))
    require(got.shape == want.shape and torch.equal(got, want),
            "sparse_ckpt_tam_rle_read: payloads != what each rank wrote")
    emit({"phase": "main_path", "method": "sparse_ckpt_tam_rle_read",
          "direction": "read", **rec, "payloads_equal_written": True})
    del got, s_file
    emit({"phase": "coalesce_rows", "method": "e3sm_g_tam",
          **coalesce_rows(torch, *runs["e3sm_g_tam"])})
    for name, (fn, args) in runs.items():
        emit({"phase": "profile", "method": name,
              **profile_write(torch, fn, args)})
    rle = ("zero_skip_encode", "zero_skip_decode")
    needed = {"e3sm_g_twophase": ("fused_sort_pack",),
              "e3sm_g_tam": ("fused_sort_pack", "bitonic_sort", "coalesce"),
              "sparse_ckpt_tam_rle": ("fused_sort_pack", "bitonic_sort",
                                      "coalesce") + rle,
              "sparse_ckpt_tam_rle_read": rle}
    for method, names in needed.items():
        for k in names:
            require(launches[method][k] > 0, f"{method}: {k} never launched")
    return {k: sum(c[k] for c in launches.values())
            for k in next(iter(launches.values()))}


@contextlib.contextmanager
def watching_pack(calls):
    """Hand every ``kernels.ops.pack`` call's arguments to ``calls`` (a
    list) while passing it on unchanged."""
    import importlib
    ops = importlib.import_module("repro_torch.kernels.ops")
    saved = ops.pack

    def watch(r, starts, data, base, out_len):
        calls.append((r, starts, data, base, out_len))
        return saved(r, starts, data, base, out_len)

    ops.pack = watch
    try:
        yield
    finally:
        ops.pack = saved


def timings_dict(t) -> dict:
    """Every ``IOTimings`` field and property."""
    d = dict(vars(t))
    for prop in ("total", "comm", "coalesce_ratio", "cache_hit_ratio",
                 "slow_hop_compression_ratio", "hidden_fraction"):
        d[prop] = getattr(t, prop)
    return d


def phase_host(torch, dev, reps):
    """The host executor on the card (``checkpoint.HostCollectiveIO``):
    1024 ranks on 16 nodes, 16 global aggregators over 1 MiB stripes,
    E3SM-G at 128 requests of 512 B a rank (a 64 MiB file, seed 0).
    ``tam`` and ``twophase`` single shot, then with ``cb_bytes`` = 1 MiB
    at ``pipeline_depth=2``, ``tam`` single shot with ``rle`` on the slow
    hop (encoded and decoded on the host, one message at a time), then a
    read of what was written. Checks:
    ``read_file`` equals a numpy image built from the rank requests, the
    methods give equal files, the read returns every rank's payload, and
    ``pack`` (each domain image, window by window) launched. Returns the
    launches of the runs and ``pack``'s measurement at the phase's
    shape."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import HostCollectiveIO
    from repro_torch.core.plan import IOConfig
    from repro_torch.io_patterns.generators import e3sm_g_pattern
    from repro_torch.kernels import ref
    reqs = e3sm_g_pattern(1024, reqs_per_rank=128, req_bytes=512, seed=0)
    file_len = 1024 * 128 * 512
    image = np.zeros(file_len, np.uint8)
    for offs, lens, data in reqs:
        idx = (offs[:, None] + np.arange(512)).reshape(-1)
        image[idx] = data
    io = HostCollectiveIO(n_ranks=1024, n_nodes=16, stripe_size=1 << 20,
                          stripe_count=16, device=dev)
    configs = {
        "single": IOConfig(req_cap=0, data_cap=0),
        "cb_1MiB_d2": IOConfig(req_cap=0, data_cap=0,
                               cb_buffer_size=1 << 20, pipeline=True,
                               pipeline_depth=2)}
    runs = [(f"host_{method}_{cname}", method, cfg)
            for cname, cfg in configs.items()
            for method in ("tam", "twophase")]
    # the slow hop's codec runs on the host, one message at a time
    runs.append(("host_tam_single_rle", "tam",
                 IOConfig(req_cap=0, data_cap=0, slow_hop_codec="rle")))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_host_")
    launches, files, calls = {}, {}, []
    try:
        for name, method, cfg in runs:
            path = os.path.join(tmp, name)
            calls.clear()
            with watching_pack(calls):
                t, rec = run_measured(
                    torch, dev, lambda: io.write(
                        reqs, path, method=method, config=cfg), ())
            launches[name] = rec["launches"]
            got = io.read_file(path, file_len).cpu().numpy()
            require(got.tobytes() == image.tobytes(),
                    f"{name}: read_file != the numpy image")
            files[name] = got.tobytes()
            require(launches[name]["pack"] > 0,
                    f"{name}: pack never launched")
            require(cfg.slow_hop_codec is None or (
                t.slow_hop_codec == "rle" and t.slow_hop_raw_bytes > 0),
                f"{name}: the slow hop was not encoded")
            shapes = sorted({(c[0].capacity, c[4]) for c in calls})
            emit({"phase": "host", "method": name, **rec,
                  "pack_calls_per_write": len(calls) // 2,
                  "pack_shapes": shapes,
                  "file_equals_image": True,
                  "timings": timings_dict(t)})
            if name == "host_twophase_cb_1MiB_d2":
                pack_args = calls[-1]
        require(len(set(files.values())) == 1, "host files differ")
        rd = [(o, ln) for o, ln, _ in reqs]
        path = os.path.join(tmp, "host_tam_cb_1MiB_d2")
        (outs, t), rec = run_measured(
            torch, dev, lambda: io.read(rd, path, config=configs[
                "cb_1MiB_d2"]), ())
        launches["host_read"] = rec["launches"]
        require(len(outs) == 1024 and all(
            o.device.type == "cuda" and np.array_equal(o.cpu().numpy(), d)
            for o, (_, _, d) in zip(outs, reqs)),
            "host read: payloads != what each rank wrote")
        emit({"phase": "host", "method": "host_read", **rec,
              "payloads_equal_written": True, "timings": timings_dict(t)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # pack at this phase's shape: one window of one domain image
    from repro_torch.kernels import ops
    r, st, data, base, out_len = pack_args
    flush = torch.empty(1 << 25, dtype=torch.int32, device=dev)
    want = ref.pack_ref(r.offsets, r.lengths, st, data, base, out_len)
    got = ops.pack(r, st, data, base, out_len)
    err = max_abs_err(torch, (got,), (want,))
    require(err == 0, "pack at the host shape != pack_ref")
    cap = max(r.capacity, 2)
    covered = int(r.lengths.to(torch.int64).sum().item())
    b, by = bound(3 * cap * 4 + covered + out_len, out_len * math.log2(cap))
    rec = {"shape": [r.capacity], "out_len": out_len, "covered": covered,
           "dtype": "uint8", "max_abs_err": err,
           "ms": time_ms(torch, lambda: ops.pack(r, st, data, base, out_len),
                         reps, flush),
           "plain_ms": time_ms(torch, lambda: ref.pack_ref(
               r.offsets, r.lengths, st, data, base, out_len), reps, flush),
           "library_ms": None, "bound_ms": b, "bound_by": by}
    emit({"phase": "kernel", "kernel": "pack", "path": "host", **rec})
    del flush
    return ({k: sum(c[k] for c in launches.values())
             for k in next(iter(launches.values()))}, rec)


def phase_mp(torch, dev):
    """The multi-process transport on the card's machine
    (``transport="mp"``): 16 ranks over 4 nodes (the reference's
    transport tests' size), E3SM-G at 8 requests of 96 B a rank, cb
    256 B at depth 2 with ``rle`` on the wire. The workers are forked
    after CUDA is in use and touch host copies only; ``tam`` and
    ``twophase`` segments equal the in-process host executor's on the
    same requests."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import HostCollectiveIO
    from repro_torch.core.plan import IOConfig
    from repro_torch.io_patterns.generators import e3sm_g_pattern
    reqs = e3sm_g_pattern(16, reqs_per_rank=8, req_bytes=96, seed=4)
    io = HostCollectiveIO(n_ranks=16, n_nodes=4, stripe_size=1024,
                          stripe_count=2, device=dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    try:
        for method in ("tam", "twophase"):
            segs = {}
            for transport in (None, "mp"):
                cfg = IOConfig(req_cap=0, data_cap=0, cb_buffer_size=256,
                               pipeline=True, pipeline_depth=2,
                               slow_hop_codec="rle", transport=transport)
                path = os.path.join(tmp, f"{method}_{transport}")
                t0 = time.perf_counter()
                t = io.write(reqs, path, method=method, config=cfg)
                wall = time.perf_counter() - t0
                segs[transport] = [open(f"{path}.seg{g}", "rb").read()
                                   for g in range(2)]
            require(segs[None] == segs["mp"],
                    f"mp {method}: segments != the host executor's")
            emit({"phase": "mp", "method": method, "wall_s": wall,
                  "segments_equal_host": True,
                  "slow_hop_slow_bytes": t.slow_hop_slow_bytes,
                  "slow_hop_fast_bytes": t.slow_hop_fast_bytes,
                  "messages_at_ga": t.messages_at_ga,
                  "rounds": t.rounds_executed,
                  "comm_wall_s": t.inter_comm, "io_wall_s": t.io})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- training

TRAIN_LAYERS = 2              # one local and one global layer (a period)
TRAIN_SEQ = 4096              # the reference's train_4k
TRAIN_BATCH = 1               # cut from train_4k's 256
TRAIN_STEPS = 4
TRAIN_FAIL_AFTER = 2          # checkpoint at 2, the host dies before 3
TRAIN_LOSS_REL = 1e-4         # resumed vs uninterrupted losses
# the backward kernel vs flash_attention_bwd_ref given the plain
# forward's output: per element |got - want| <= rtol |want| + atol
# max|want|, and a relative L2 distance. dP and dv are rounded to bf16,
# and a sum in another order may round to a neighbour (two ulps across
# a power of two): rtol 1.6e-2; a dP rounded the other way under a
# probability near 1 moves dq and dk by up to about 1.7e-3 of their
# largest element in f32 (the flash_attention_bwd lines' max_abs_err
# over max_abs_want). The L2 limit is what a wrong gradient fails
# (planted faults: 2e-2 and up)
BWD_TOL = {"float32": {"rtol": 1.6e-2, "atol": 2e-3, "rel_l2": 1e-4},
           "bfloat16": {"rtol": 1.6e-2, "atol": 1e-2, "rel_l2": 1e-2}}
# (name, dtype, window): gemma2-9b's attention at the training path's
# shape, q [1, 4096, 16, 256] against k, v [1, 4096, 8, 256], causal,
# softcap 50: the global layer, the local layer (window 4096 masks
# nothing at 4096 tokens), a window of 1024 (where one key more or less
# changes the gradient: the off-by-one fault), and bf16
BWD_CASES = (("global", "float32", None), ("window_4096", "float32", 4096),
             ("window_1024", "float32", 1024),
             ("global_bf16", "bfloat16", None))
BWD_LIBRARY = ("yardstick, not the same function: the backward of "
               "torch.nn.functional.scaled_dot_product_attention in f32 "
               "(its backend's choice), causal, no softcap, k and v "
               "expanded to 16 heads, by torch.autograd.grad of a forward "
               "taken before the timer (SDPA's and flex_attention's "
               "backward keep p.v and dP in f32, the model's attention "
               "rounds them to bf16)")
# the backward's three launches, by their bit of the pass mask
# (flash._launch_bwd), and the products of hd a visible pair it computes
# at these shapes, where it keeps the logits' q . k from the stats pass
# (flash.BWD_DOTS_MAX_BYTES): TF32 mma (the split's terms: dq pass dP 2,
# dq 3; dk/dv pass dP 2, dk 3; bf16 inputs: dq and dk 2, dv 2, and the
# logits 1) and f32 FMA chains (f32 inputs: the logits once, and dv)
BWD_PASSES = {"stats": 1, "dq": 2, "dkdv": 4}
BWD_PRODUCTS = {"float32": {"tf32": 10, "fma": 2},
                "bfloat16": {"tf32": 11, "fma": 0}}


def bwd_err(got, want, dname) -> dict:
    """Every element and the relative L2 distance of one gradient
    against the plain one, under ``BWD_TOL``."""
    tol = BWD_TOL[dname]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    scale = float(w.abs().max())
    rel = float((g - w).norm() / w.norm().clamp(min=1e-30))
    return {"max_abs_err": float(err.max()), "max_abs_want": scale,
            "rel_l2": rel,
            "within": bool((err <= tol["rtol"] * w.abs()
                            + tol["atol"] * scale).all())
            and rel <= tol["rel_l2"]}


def grads_err(got, want, dname) -> dict:
    per = {n: bwd_err(g, w, dname) for n, g, w in
           zip(("dq", "dk", "dv"), got, want)}
    return {"per_grad": per, "within": all(c["within"] for c in per.values()),
            "max_abs_err": max(c["max_abs_err"] for c in per.values())}


def bwd_bound(torch, q_shape, k_shape, itemsize, causal, window):
    """``(bound_ms, bound_by, pairs, f32_cores_ms)`` of one backward:
    q, k, v, out and dout read once and dq, dk, dv written once at the
    memory rate, against 2.5x the forward's operations (five products of
    hd a visible pair: S, dP, dV, dK, dQ) at the dense tensor-core rate
    of the type (TF32 for f32: the least time the card could take; the
    kernel itself runs f32 FMAs, whose time at 67 TFLOP/s is beside)."""
    b, sq, hq, hd = q_shape
    from repro_torch.launch.op_analysis import attention_work
    pairs, _ = attention_work(b, sq, hq, k_shape[1], causal, window, 0, None)
    ops = 10 * hd * pairs
    peak = PEAK_FLOPS_BF16 if itemsize == 2 else PEAK_FLOPS_TF32
    t_ops = ops / peak * 1e3
    n_q = b * sq * hq * hd
    n_k = k_shape[0] * k_shape[1] * k_shape[2] * k_shape[3]
    t_bytes = (4 * n_q + 4 * n_k) * itemsize / HBM_BW * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", pairs, ops / PEAK_FLOPS_F32 * 1e3)


def bwd_pass_ms(torch, q, k, v, out, dout, kw, reps, flush) -> dict:
    """Device time (ms) of each of the backward's passes: a full call
    fills the scratch, then each pass alone (``flash._launch_bwd`` with
    one bit of the mask; not a launch of the path) is timed by CUDA
    events (``time_ms``)."""
    from repro_torch.kernels import flash
    grads = [torch.empty_like(t) for t in (q, k, v)]
    scratch = flash.bwd_scratch(q, k.shape[1])
    kw = {**kw, "kv_len": k.shape[1] if kw["kv_len"] is None
          else min(kw["kv_len"], k.shape[1])}

    def run(passes):
        flash._launch_bwd(q, k, v, out, dout, grads, scratch, kw, passes)
    run(flash.BWD_ALL_PASSES)
    return {name: time_ms(torch, lambda m=mask: run(m), reps, flush)
            for name, mask in BWD_PASSES.items()}


def sdpa_bwd_ms(torch, q, k, v, dout, reps, flush) -> float:
    """The yardstick of ``BWD_LIBRARY``: SDPA's backward at the case's
    shapes in f32, causal, no softcap, k and v expanded to q's heads."""
    import torch.nn.functional as F
    g = q.shape[2] // k.shape[2]
    leaves = [x.float().repeat_interleave(r, dim=2).transpose(1, 2)
              .contiguous().requires_grad_(True)
              for x, r in ((q, 1), (k, g), (v, g))]
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    d = dout.float().transpose(1, 2).contiguous()
    ms = time_ms(torch, lambda: torch.autograd.grad(
        out, leaves, d, retain_graph=True), reps, flush)
    del out, leaves, d
    return ms


def phase_train_kernel(torch, dev, reps):
    """``flash_attention_bwd`` against ``flash_attention_bwd_ref`` at the
    training path's shapes (``BWD_CASES``; q and k of std 2, so the
    logits span a few units and the softcap bends them), both given the
    plain forward's output: every gradient within ``BWD_TOL``, two runs
    bit-equal, and planted faults failing the check: the softcap's
    derivative dropped (the plain backward through a straight-through
    tanh), the window one key short (the kernel at ``window - 1``, where
    the window masks keys) and the D term dropped (the kernel given a
    zero ``out``: D = dO' . out). Each case's line also gives the device
    time of each pass (``bwd_pass_ms``) and the TFLOP/s achieved on the
    bound's five products and on the TF32 products the split issues; the
    global f32 case times SDPA's backward beside it (``BWD_LIBRARY``).
    Returns the global f32 case's line with the others beside it."""
    from unittest import mock
    from repro_torch.kernels import flash, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    flush = torch.empty(1 << 25, dtype=torch.int32, device=dev)
    b, s, hq, hkv, hd = TRAIN_BATCH, TRAIN_SEQ, 16, 8, 256
    recs = {}
    tanh = torch.tanh
    for name, dname, window in BWD_CASES:
        dtype = getattr(torch, dname)
        q, k = ((2 * torch.randn(sh, generator=gen, device=dev)).to(dtype)
                for sh in ((b, s, hq, hd), (b, s, hkv, hd)))
        v = torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(dtype)
        dout = torch.randn((b, s, hq, hd), generator=gen,
                           device=dev).to(dtype)
        kw = dict(causal=True, window=window, logit_cap=50.0, q_offset=0,
                  kv_len=None)
        out = ref.flash_attention_ref(q, k, v, **kw)
        before = flash.flash_attention_bwd.launches
        got = flash.flash_attention_bwd(q, k, v, out, dout, **kw)
        again = flash.flash_attention_bwd(q, k, v, out, dout, **kw)
        require(flash.flash_attention_bwd.launches == before + 2,
                f"bwd {name}: launches")
        bit_equal = all(torch.equal(x, y) for x, y in zip(got, again))
        del again
        want = ref.flash_attention_bwd_ref(q, k, v, out, dout, **kw)
        check = grads_err(got, want, dname)
        planted = {}
        with mock.patch.object(torch, "tanh",
                               lambda x: x + (tanh(x) - x).detach()):
            planted["softcap_derivative_dropped"] = grads_err(
                ref.flash_attention_bwd_ref(q, k, v, out, dout, **kw),
                want, dname)
        if window is not None and s > window:
            planted["window_short_one"] = grads_err(
                flash.flash_attention_bwd(q, k, v, out, dout,
                                          **{**kw, "window": window - 1}),
                want, dname)
        planted["d_dropped"] = grads_err(flash.flash_attention_bwd(
            q, k, v, torch.zeros_like(out), dout, **kw), want, dname)
        del got, want
        bound_ms, bound_by, pairs, f32_ms = bwd_bound(
            torch, q.shape, k.shape, q.element_size(), True, window)

        def kernel():
            return flash.flash_attention_bwd(q, k, v, out, dout, **kw)
        rec = {"case": name, "dtype": dname, "q": list(q.shape),
               "kv": list(k.shape), "causal": True, "window": window,
               "logit_cap": 50.0, "max_abs_err": check["max_abs_err"],
               "grads": check["per_grad"], "tol": BWD_TOL[dname],
               "bit_equal_repeat": bit_equal,
               "planted_within": {f: c["within"] for f, c in planted.items()},
               "planted_rel_l2": {f: {n: c["per_grad"][n]["rel_l2"]
                                      for n in c["per_grad"]}
                                  for f, c in planted.items()},
               "pairs": pairs,
               "ms": time_ms(torch, kernel, reps, flush),
               "passes_ms": bwd_pass_ms(torch, q, k, v, out, dout, kw, reps,
                                        flush),
               "plain_ms": time_ms(torch, lambda: ref.flash_attention_bwd_ref(
                   q, k, v, out, dout, **kw), 2, flush),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "f32_cores_bound_ms": f32_ms,
               "library_ms": (sdpa_bwd_ms(torch, q, k, v, dout, reps, flush)
                              if name == "global" else None),
               "library": BWD_LIBRARY if name == "global" else None,
               "products_issued": BWD_PRODUCTS[dname]}
        rec["achieved_tflops"] = 10 * hd * pairs / rec["ms"] / 1e9
        rec["issued_tflops"] = (2 * sum(BWD_PRODUCTS[dname].values()) * hd
                                * pairs / rec["ms"] / 1e9)
        emit({"phase": "kernel", "kernel": "flash_attention_bwd", **rec})
        require(check["within"], f"bwd {name}: {check}")
        require(bit_equal, f"bwd {name}: two runs differ")
        for fault, c in planted.items():
            require(not c["within"], f"bwd {name}: the planted fault "
                    f"{fault} passes the check")
        recs[name] = rec
        del q, k, v, out, dout
        torch.cuda.empty_cache()
    del flush
    main = recs["global"]
    return {**main, "other_cases": {n: {k: r[k] for k in (
        "dtype", "window", "ms", "passes_ms", "bound_ms", "plain_ms",
        "max_abs_err", "achieved_tflops", "issued_tflops")}
        for n, r in recs.items() if n != "global"}}


PACK_REF_CHUNK = 1 << 26   # positions pack_ref takes at a time in training


def train_pack_case(torch, dev, calls, reps) -> dict:
    """``ops.pack`` at the training path's shape: the largest of a save's
    calls (one window of one domain image), exact against ``pack_ref``
    and timed against it and the bound. ``pack_ref`` runs over the
    window ``PACK_REF_CHUNK`` positions at a time (its int64
    intermediates for a whole 1 GiB window would take some 40 GB beside
    the training state); a chunk is the same call with the base moved on,
    so the chunks join to the whole call's result."""
    from repro_torch.kernels import ops, ref
    r, st, data, base, out_len = max(calls, key=lambda c: c[4])

    def plain(i, n):
        return ref.pack_ref(r.offsets, r.lengths, st, data, int(base) + i, n)

    def plain_all():
        for i in range(0, out_len, PACK_REF_CHUNK):
            plain(i, min(PACK_REF_CHUNK, out_len - i))

    got = ops.pack(r, st, data, base, out_len)
    err = 0
    for i in range(0, out_len, PACK_REF_CHUNK):
        n = min(PACK_REF_CHUNK, out_len - i)
        err = max(err, max_abs_err(torch, (got[i:i + n],), (plain(i, n),)))
    require(err == 0, "pack at the training shape != pack_ref")
    del got
    flush = torch.empty(1 << 25, dtype=torch.int32, device=dev)
    cap = max(r.capacity, 2)
    covered = int(r.lengths.to(torch.int64).sum().item())
    b, by = bound(3 * cap * 4 + covered + out_len, out_len * math.log2(cap))
    rec = {"shape": [r.capacity], "out_len": out_len, "covered": covered,
           "dtype": "uint8", "calls_in_save": len(calls),
           "out_lens_in_save": sorted(c[4] for c in calls),
           "max_abs_err": err,
           "ms": time_ms(torch, lambda: ops.pack(r, st, data, base, out_len),
                         reps, flush),
           "plain_ms": time_ms(torch, plain_all, reps, flush),
           "plain_chunk": PACK_REF_CHUNK,
           "library_ms": None, "bound_ms": b, "bound_by": by}
    del flush
    emit({"phase": "kernel", "kernel": "pack", "path": "train", **rec})
    return rec


def state_digest(torch, tree, chunk=1 << 26):
    """Per leaf, two int64 sums over its bits (as int16 or int32 words):
    the plain sum and one weighted by position mod 1021, computed on the
    card in chunks; equal digests for equal bytes, and a byte that moves
    or changes changes them."""
    from repro_torch._tree import leaves_with_paths
    out = []
    for path, t in leaves_with_paths(tree):
        flat = t.detach().reshape(-1)
        word = torch.int16 if flat.element_size() == 2 else torch.int32
        bits = flat.view(word) if flat.element_size() in (2, 4) \
            else flat.view(torch.uint8)
        s0 = s1 = 0
        for i in range(0, bits.numel(), chunk):
            x = bits[i:i + chunk].to(torch.int64)
            w = torch.arange(i, i + x.numel(), device=x.device) % 1021 + 1
            s0 += int(x.sum())
            s1 += int((x * w).sum())
        out.append((path, s0, s1))
    return out


def phase_train(torch, dev, tmp):
    """Training with checkpoint and restart on the card, through
    ``launch.train.build_training`` (the reference CLI's objects):
    gemma2-9b at full width cut to ``TRAIN_LAYERS`` layers, f32
    parameters seeded 0, ``adamw`` with ``warmup_cosine``, batch
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens of the synthetic pipeline, and
    a TAM ``CheckpointManager`` on the reference's 8-rank writer.

    1. An uninterrupted control of ``TRAIN_STEPS`` steps: its losses and
       a digest of its final state kept on the host; each step split
       into forward, backward and optimizer by CUDA events.
    2. A faulty run: the loop checkpoints every ``TRAIN_FAIL_AFTER``
       steps; after that step's save the heartbeat monitor loses a host
       and the next step raises; ``find_restart_step`` names the step,
       ``CheckpointManager.restore`` brings the state back (its digest
       must equal the saved state's), and a new loop runs from there to
       ``TRAIN_STEPS`` (saving again at its end).

    Launch counts are set to 0 before the control and read after the
    resumed run. Checks: the resumed losses equal the control's within
    ``TRAIN_LOSS_REL`` (bit-equality printed), the seeded model's
    logits through the kernels equal those with attention forced
    through the plain version within ``SERVE_REL_L2``, the first loss is
    finite and equals the seeded model's loss through the plain
    attention within ``TRAIN_LOSS_REL``, and ``pack`` and both attention
    kernels launched, and the attention routes' launches add up to the
    kernel's. The first save's largest ``pack`` call is held to
    ``pack_ref`` and timed after that save (``train_pack_case``; its
    launches are not counted). Printed beside: ln(vocab), and the loss
    on the positions whose label is not the input token (with tied
    embeddings the input token's own logit, softcapped near 30,
    dominates a seeded model's partition function). Returns the
    launches, the attention launches by route, the ``pack`` case, and
    what ``phase_serve_restore`` serves from: the faulty run's checkpoint
    directory under ``tmp`` (left in place), a like tree of the state,
    the digest of its newest save, and the parameters the resumed run
    ended with."""
    import dataclasses
    from repro_torch import configs, kernels
    from repro_torch._tree import leaves, tree_map
    from repro_torch.kernels import flash, ref
    from repro_torch.launch.train import build_training
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    from repro_torch.runtime import HeartbeatMonitor, find_restart_step
    cfg = dataclasses.replace(configs.get("gemma2_9b"),
                              n_layers=TRAIN_LAYERS)
    marks = []

    def mark(what):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((what, e))

    def fresh(sub, every, hook=None):
        return build_training(
            "gemma2_9b", cfg=cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
            seq=TRAIN_SEQ, lr=3e-3, ckpt_dir=os.path.join(tmp, sub),
            ckpt_every=every, log_every=1, device=dev, phase_hook=hook)

    saves = []

    def take(run):
        """The run's initial state, dropped from the run, so the loop
        frees it once its first step has replaced it."""
        state = (run.params, run.opt_state)
        run.params = run.opt_state = None
        return state

    pack_case = {}

    def timed_saves(mgr):
        """Time each of the manager's saves (wall, peak memory, pack
        launches, IOTimings) and keep the saved state's digest. The
        first save's largest ``pack`` call is held to ``pack_ref`` and
        timed once the save is done (``pack_case``); those launches are
        counted apart and taken off the phase's count."""
        save = mgr.save

        def run(tree, step, faults=None):
            digest = state_digest(torch, tree)
            calls = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            pack0 = kernels.launch_counts()["pack"]
            t0 = time.perf_counter()
            with watching_pack(calls if not saves else []):
                timings = save(tree, step, faults)
            torch.cuda.synchronize()
            saves.append({"step": step,
                          "wall_s": time.perf_counter() - t0,
                          "peak_mem_bytes":
                              torch.cuda.max_memory_allocated(dev),
                          "pack_launches":
                              kernels.launch_counts()["pack"] - pack0,
                          "timings": timings_dict(timings),
                          "digest": digest})
            if calls:
                pack0 = kernels.launch_counts()["pack"]
                pack_case.update(train_pack_case(torch, dev, calls, REPS))
                pack_case["check_launches"] = \
                    kernels.launch_counts()["pack"] - pack0
            return timings
        mgr.save = run

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    control = fresh("control", 10 ** 9, mark)
    n_params = sum(p.numel() for p in leaves(control.params))
    # the seeded model's logits: kernels vs plain attention, and the
    # loss where the label is not the input token
    batch0 = control.data.batch_at(0)
    with torch.no_grad():
        logits_k, _ = T.forward(control.params, cfg, batch0)
        with patched_attention(layers, lambda _: ref.flash_attention_ref):
            logits_p, _ = T.forward(control.params, cfg, batch0)
        vs_plain = logit_stats(torch, logits_k, logits_p)
        lab = batch0["labels"][..., None].long()
        nll_p = torch.logsumexp(logits_p, -1) - torch.take_along_dim(
            logits_p, lab, -1)[..., 0]
        del logits_p
        nll = torch.logsumexp(logits_k, -1) - torch.take_along_dim(
            logits_k, lab, -1)[..., 0]
        del logits_k
        other = batch0["labels"] != batch0["tokens"]
        nll_other = float(nll[other].mean())
        loss0_eval, loss0_plain = float(nll.mean()), float(nll_p.mean())
        del nll, nll_p
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    loop_c = control.loop()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_c, o_c, _ = loop_c.run(*take(control))
    torch.cuda.synchronize()
    control_wall = time.perf_counter() - t0
    losses_c = list(loop_c.losses)
    digest_c = state_digest(torch, {"params": p_c, "opt": o_c})
    steps_ms = []
    for i in range(0, len(marks), 4):
        (_, a), (_, f), (_, bw), (_, o) = marks[i:i + 4]
        steps_ms.append({"forward_ms": a.elapsed_time(f),
                         "backward_ms": f.elapsed_time(bw),
                         "optimizer_ms": bw.elapsed_time(o),
                         "step_ms": a.elapsed_time(o)})
    phase_peak = torch.cuda.max_memory_allocated(dev)
    emit({"phase": "train", "run": "control", "arch": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "seq": TRAIN_SEQ, "batch": TRAIN_BATCH, "params": n_params,
          "param_dtype": "float32",
          "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "steps": TRAIN_STEPS, "wall_s": control_wall,
          "losses": losses_c, "steps_ms": steps_ms,
          "peak_mem_bytes": phase_peak,
          "logits_kernel_vs_plain": vs_plain,
          "loss_seeded": loss0_eval, "loss_seeded_plain": loss0_plain,
          "loss_label_not_input": nll_other,
          "ln_vocab": math.log(cfg.vocab),
          "label_is_input_share": 1.0 - float(other.float().mean())})
    del p_c, o_c, control, loop_c
    torch.cuda.empty_cache()

    # the faulty run: save at TRAIN_FAIL_AFTER, lose a host, restart
    faulty = fresh("faulty", TRAIN_FAIL_AFTER)
    timed_saves(faulty.ckpt)
    monitor = HeartbeatMonitor(n_hosts=2, timeout_s=1e9)

    def on_step(step, loss):
        if step == TRAIN_FAIL_AFTER:
            monitor.inject_failure(1)

    loop_f = faulty.loop(monitor)
    # restore takes the structure and each leaf's device from this
    like = tree_map(lambda t: torch.empty(0, device=t.device),
                    {"params": faulty.params, "opt": faulty.opt_state})
    failed = None
    try:
        loop_f.run(*take(faulty), on_step=on_step)
    except RuntimeError as exc:
        failed = str(exc)
    require(failed is not None and "host failure" in failed,
            f"train: the lost host did not stop the loop ({failed})")
    losses_f = list(loop_f.losses)
    start = find_restart_step(faulty.ckpt.directory)
    require(start == TRAIN_FAIL_AFTER,
            f"train: find_restart_step gave {start}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, step, r_timings = faulty.ckpt.restore(like, start,
                                                 with_timings=True)
    torch.cuda.synchronize()
    restore = {"wall_s": time.perf_counter() - t0,
               "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
               "timings": timings_dict(r_timings)}
    torch.cuda.empty_cache()
    restored_equal = state_digest(torch, state) == saves[0]["digest"]
    require(step == start and restored_equal,
            "train: the restored state differs from the saved one")
    loop_r = faulty.loop()
    final = []
    torch.cuda.reset_peak_memory_stats(dev)
    prof = profile_write(torch, lambda: final.append(loop_r.run(
        state["params"], state["opt"], start_step=start)), ())
    losses_r = list(loop_r.losses)
    launches = kernels.launch_counts()
    routes = dict(flash.flash_attention_fused.launches_by_route)
    require(bool(pack_case), "train: no pack call to hold to pack_ref")
    launches["pack"] -= pack_case["check_launches"]
    phase_peak = max([phase_peak, restore["peak_mem_bytes"],
                      torch.cuda.max_memory_allocated(dev)]
                     + [sv["peak_mem_bytes"] for sv in saves])
    del state
    p_r, o_r, _ = final.pop()
    digest_r = state_digest(torch, {"params": p_r, "opt": o_r})
    del o_r
    resumed = losses_f + losses_r
    bit_equal = resumed == losses_c
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, losses_c)) \
        if len(resumed) == len(losses_c) else math.inf
    emit({"phase": "train", "run": "faulty_and_resumed",
          "failure": failed, "restart_step": start,
          "losses_before_failure": losses_f, "losses_resumed": losses_r,
          "losses_control": losses_c, "losses_bit_equal": bit_equal,
          "max_rel_diff": rel,
          "final_state_bit_equal_control": digest_r == digest_c,
          "saves": [{k: v for k, v in sv.items() if k != "digest"}
                    for sv in saves],
          "saves_note": "the save after the restart ran under the "
                        "profiler (resumed_profile)",
          "restore": restore, "restored_equals_saved": restored_equal,
          "resumed_profile": prof, "launches": launches,
          "flash_launches_by_route": routes,
          "phase_peak_mem_bytes": phase_peak,
          "phase_wall_s": time.perf_counter() - t_phase})
    require(len(resumed) == len(losses_c) and rel <= TRAIN_LOSS_REL,
            f"train: resumed losses {resumed} vs control {losses_c}")
    require(math.isfinite(losses_c[0]) and abs(
        losses_c[0] - loss0_plain) <= TRAIN_LOSS_REL * abs(loss0_plain),
        f"train: first loss {losses_c[0]} vs the plain attention's "
        f"{loss0_plain}")
    require(vs_plain["rel_l2"] <= SERVE_REL_L2,
            f"train: logits through the kernels vs plain: {vs_plain}")
    for k in ("pack", "flash_attention_fused", "flash_attention_bwd"):
        require(launches[k] > 0, f"train: {k} never launched")
    require(sum(routes.values()) == launches["flash_attention_fused"],
            f"train: flash routes {routes} vs {launches}")
    require(routes["tc_f32"] == launches["flash_attention_fused"],
            f"train: f32 attention off the tc_f32 route: {routes}")
    torch.cuda.empty_cache()
    trained = {"cfg": cfg, "dir": faulty.ckpt.directory, "like": like,
               "digest": saves[-1]["digest"], "step": saves[-1]["step"],
               "params": p_r}
    return launches, routes, pack_case, trained


# gemma2-9b's roofline cells (launch/shapes.py), cut only as far as one
# card's 80 GB forces: (shape, layers, global batch, why)
ROOFLINE_CELLS = (
    ("train_4k", 2, 1,
     "42 layers' bf16 weights, gradients and AdamW moments take 74 GB "
     "before any activation; batch 256's f32 logits alone 1.07 TB"),
    ("prefill_32k", 42, 1,
     "each sequence's 32768-long KV caches take 11.3 GB beside 18.5 GB "
     "of weights: batch 32 would need 361 GB"),
    ("decode_32k", 42, 4,
     "each sequence's KV caches take 11.3 GB: batch 4 takes 45.1 GB, "
     "batch 128 would need 1.44 TB"),
)
ROOFLINE_REPS = 5             # timed steps a cell, after one warm-up
ROOFLINE_ROUTES = {"train_4k": ("tc_prefill",),
                   "prefill_32k": ("tc_prefill",),
                   "decode_32k": ("split_decode",)}


def attention_signature(q, k, kw) -> tuple:
    """A hashable key of one attention call: q's and k's shapes, the
    type, the masks."""
    return (tuple(q.shape), tuple(k.shape), str(q.dtype).split(".")[-1],
            tuple(sorted(kw.items())))


def roofline_attention_checks(torch, dev, cell, calls) -> list:
    """The kernel at every attention shape ``cell``'s step gave it
    (``calls``: ``attention_signature`` -> calls in the counted step), on
    seeded inputs of that shape and type, against
    ``ref.flash_attention_ref`` within ``ATTN_TOL``, with the
    ``planted_faults`` of that call required to fail the same check:
    the 32768-token prefills (global and window 4096) and the decode
    against a 32768-long cache at position 32767, beyond the 8784 keys
    of ``FLASH_CASES``. Each call must launch once, on the route
    ``flash._route`` picks and the cell expects (``ROOFLINE_ROUTES``).
    These launches fall after the cell's counts are read and before the
    next cell's reset: they count in no run of the main path. Beyond the
    8784 keys of ``FLASH_CASES`` (the prefill and decode cells), compiled
    ``flex_attention`` computes the same function (``flex_library``, held
    to the same check) and gives the line its ``library_ms``."""
    from repro_torch.kernels import flash, ops, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    recs = []
    for (q_shape, k_shape, dname, kw_items), n in calls.items():
        kw = dict(kw_items)
        dtype = getattr(torch, dname)
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
                   for s in (q_shape, k_shape, k_shape))
        route = flash._route(q_shape[0], q_shape[1], q_shape[2],
                             k_shape[2], q_shape[3], dtype)
        before = dict(flash.flash_attention_fused.launches_by_route)
        got = ops.fused_attention(q, k, v, **kw)
        launched = {r: c - before[r] for r, c in
                    flash.flash_attention_fused.launches_by_route.items()
                    if c != before[r]}
        want = ref.flash_attention_ref(q, k, v, **kw)
        tol = ATTN_TOL[dname]
        check = attn_err(got, want, tol)
        planted = {f: attn_err(fn(), want, tol) for f, fn in
                   planted_faults(ops, q, k, v, got, kw).items()}
        lib = {"library_ms": None, "library": None}
        if cell != "train_4k" and kw.get("logit_cap") is not None:
            lib = flex_library(torch, q, k, v, {"kv_len": None, **kw}, want,
                               tol, 3, None)
        del got, want
        bound_ms, bound_by, pairs, keys = attention_bound(
            torch, q_shape, k_shape, q.element_size(), kw["causal"],
            kw["window"], kw["q_offset"], kw.get("kv_len"))
        rec = {"phase": "roofline_attention", "cell": cell, "q": q_shape,
               "kv": k_shape, "dtype": dname, **kw, "calls_in_step": n,
               "route": route, "launched": launched,
               "max_abs_err": check["max_abs_err"],
               "rel_l2": check["rel_l2"], "rms_want": check["rms_want"],
               "tol": tol, "tol_rel_l2": ATTN_REL_L2,
               "planted_rel_l2": {f: c["rel_l2"]
                                  for f, c in planted.items()},
               "pairs": pairs, "keys_read": keys,
               "ms": time_ms(torch, lambda: ops.fused_attention(
                   q, k, v, **kw), 3),
               "bound_ms": bound_ms, "bound_by": bound_by, **lib}
        emit(rec)
        require(launched == {route: 1} and route in ROOFLINE_ROUTES[cell],
                f"roofline {cell} attention {q_shape} {k_shape} {kw}: "
                f"launched {launched}, picked {route}")
        require(check["within"], f"roofline {cell} attention {q_shape} "
                f"{k_shape} {kw}: {check}")
        for fault, c in planted.items():
            require(not c["within"], f"roofline {cell} attention "
                    f"{q_shape} {k_shape}: the planted fault {fault} "
                    f"passes the check: {c}")
        recs.append(rec)
        del q, k, v
        torch.cuda.empty_cache()
    return recs


def phase_roofline(torch, dev, smi=None):
    """gemma2-9b's ``train_4k``, ``prefill_32k`` and ``decode_32k`` on one
    card against the H100's roofline: full width, bf16 weights from a
    seeded generator, the reference's types (bf16 AdamW moments), each
    cell's step and arguments from ``launch.steps.input_specs`` on real
    tensors, cut as ``ROOFLINE_CELLS`` says (``reduced`` in its line).

    Per cell: one warm-up step, ``ROOFLINE_REPS`` steps timed by CUDA
    events (median), and one more step, untimed, under a
    ``launch.op_analysis.OpCounter`` (so the counter adds no host work to
    the timed ones); the peak memory over the cell; the same cut cell's
    counts traced on ``meta`` (``launch.roofline.analyze_cell``, one
    device); ``model_flops``; the three roofline terms of the card's
    counts at the H100's peaks (``launch/mesh.py``); ``mfu`` = model
    FLOPs / (step seconds x 989e12), ``hfu`` = counted FLOPs / (step
    seconds x 989e12), ``bound_over_step`` = the counts' bound / step
    time (the meta trace's ``roofline_fraction``, the reference's model
    FLOPs at peak over the bound, beside it under ``meta``). A train
    step's parameters and moments feed the next; a decode step writes
    position 32767 of a seeded 32768-long cache each time. The counted
    step also records every attention call, and after the cell is freed
    ``roofline_attention_checks`` holds the kernel against its plain
    version at each of those shapes.

    Requires: the card's counted FLOPs equal the ``meta`` trace's, the
    peak is at least the trace's argument bytes, every step's output is
    finite, and the routes launched are the cell's (``ROOFLINE_ROUTES``;
    the backward kernel in train), the attention checks pass, and the
    longest keys checked are the cell's seq. Launch counts are set to 0 before the
    timed steps and read after the counted one. Returns the launches and
    the attention's routes. ``smi``: the card's ``nvidia_smi()`` line
    (queried when not given)."""
    import dataclasses
    from repro_torch import configs, kernels
    from repro_torch._tree import leaves
    from repro_torch.kernels import flash
    from repro_torch.launch import op_analysis, roofline, shapes, steps
    from repro_torch.models import layers
    from repro_torch.models.sharding import unsharded
    base = configs.get("gemma2_9b")
    smi = smi or nvidia_smi()
    total, total_routes = None, route_counts()
    for name, depth, gb, why in ROOFLINE_CELLS:
        held = free_device(torch, dev)          # what earlier phases keep
        full = shapes.shape(name)
        cell = dataclasses.replace(full, global_batch=gb)
        cfg = dataclasses.replace(base, n_layers=depth)
        reduced = {"n_layers": [base.n_layers, depth],
                   "global_batch": [full.global_batch, gb], "why": why}
        meta = roofline.analyze_cell("gemma2_9b", name, "one", cfg=cfg,
                                     cell=cell, device="meta")
        fn, args, _, _ = steps.input_specs("gemma2_9b", cell, unsharded(),
                                           cfg=cfg, device=dev)
        args = list(args)

        def step():
            out = fn(*args)
            if cell.kind == "train":        # the next step's state
                args[0], args[1] = out[0], out[1]
                return out[2]
            return out[0]

        def finite(t):
            return bool(torch.isfinite(t.float()).all())

        ok = finite(step())                                 # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        times = []
        for _ in range(ROOFLINE_REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = step()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
            ok = ok and finite(out)
            del out
        calls = {}

        def seen(q, k, v, kw):
            key = attention_signature(q, k, kw)
            calls[key] = calls.get(key, 0) + 1

        with op_analysis.OpCounter() as counter, \
                patched_attention(layers, watching(seen)):
            out = step()
        torch.cuda.synchronize()
        ok = ok and finite(out)
        del out
        launches = kernels.launch_counts()
        routes = dict(flash.flash_attention_fused.launches_by_route)
        peak = torch.cuda.max_memory_allocated(dev)
        del fn, args
        cost = counter.cost
        ms = statistics.median(times)
        terms = roofline.roofline_terms(cost, 1)
        mf = roofline.model_flops(cfg, cell)
        step_s = ms / 1e3
        rec = {"phase": "roofline", "cell": name, "arch": cfg.name,
               "card": smi, "reduced": reduced, "seq": cell.seq,
               "step_ms": ms, "steps_ms": times,
               "peak_mem_bytes": peak, "held_before_bytes": held,
               "counted": {"flops": cost.flops, "bytes": cost.bytes,
                           "attention_flops": cost.attention_flops,
                           "flops_by_dtype": cost.flops_by_dtype,
                           "coll_bytes": cost.coll_bytes},
               "meta": {"flops": meta["flops_global"],
                        "bytes": meta["bytes_per_dev"],
                        "argument_bytes":
                            meta["mem_per_dev"]["argument_bytes"],
                        "output_bytes": meta["mem_per_dev"]["output_bytes"],
                        "roofline_fraction": meta["roofline_fraction"],
                        "trace_s": meta["analyze_s"]},
               "model_flops": mf,
               "t_compute_s": terms["t_compute_s"],
               "t_memory_s": terms["t_memory_s"],
               "t_collective_s": terms["t_collective_s"],
               "dominant": terms["dominant"], "bound_s": terms["bound_s"],
               "mfu": mf / (step_s * PEAK_FLOPS_BF16),
               "hfu": cost.flops / (step_s * PEAK_FLOPS_BF16),
               "bound_over_step": terms["bound_s"] / step_s,
               "outputs_finite": ok, "launches": launches,
               "flash_launches_by_route": routes}
        emit(rec)
        require(cost.flops == meta["flops_global"],
                f"roofline {name}: the card counted {cost.flops} FLOPs, "
                f"the meta trace {meta['flops_global']}")
        require(peak >= meta["mem_per_dev"]["argument_bytes"],
                f"roofline {name}: peak {peak} below the arguments' "
                f"{meta['mem_per_dev']['argument_bytes']} bytes")
        require(ok, f"roofline {name}: a step's output is not finite")
        require(sum(routes.values()) == launches["flash_attention_fused"]
                == sum(routes[r] for r in ROOFLINE_ROUTES[name]) > 0,
                f"roofline {name}: attention routes {routes}")
        require((launches["flash_attention_bwd"] > 0)
                == (cell.kind == "train"),
                f"roofline {name}: backward launches {launches}")
        torch.cuda.empty_cache()
        checked = roofline_attention_checks(torch, dev, name, calls)
        require(max(c["kv"][1] for c in checked) == cell.seq,
                f"roofline {name}: the attention's keys "
                f"{[c['kv'] for c in checked]}, not the cell's {cell.seq}")
        total = launches if total is None else {
            k: total[k] + launches[k] for k in total}
        total_routes = add_routes(total_routes, routes)
    free_device(torch, dev)
    return total, total_routes


# ---------------------------------------------------------------------------
# the reference's executable checkers on the card, and REPRO_PERF_OPTS=0
# through the attention kernels (their f32 p.v variants)
# ---------------------------------------------------------------------------

IO_KERNELS = ("bitonic_sort", "coalesce", "fused_sort_pack",
              "zero_skip_encode", "zero_skip_decode", "pack", "route_spans")


def phase_checks(torch, dev):
    """``repro_torch.testing.rounds_checks`` and ``spmd_checks`` in this
    process on the card (``run(dev)``), and on the CPU for their names:
    every check must PASS, under the same names as on the CPU, and each
    I/O kernel must have launched (TAM's sort and coalesce, the fused
    drain, the zero-skip pair and ``pack``, on patterns none of this
    script's cells make: nested overlaps, domain spanners, seeded random
    extents, the swapped placement, 1 to 5 rounds). Launch counts are
    set to 0 just before the card's runs and read just after. The check
    lines are kept in memory; failures are printed. Returns the
    launches and the attention's launches by route (``spmd_checks``' model
    checks run the attention)."""
    import io
    from repro_torch import kernels
    from repro_torch.kernels import flash
    from repro_torch.testing import rounds_checks, spmd_checks
    t0 = time.perf_counter()
    cpu = {m.__name__: m.run("cpu", out=io.StringIO()).names
           for m in (rounds_checks, spmd_checks)}
    cpu_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    card = {m.__name__: m.run(dev, out=io.StringIO())
            for m in (rounds_checks, spmd_checks)}
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t1
    launches = kernels.launch_counts()
    routes = dict(flash.flash_attention_fused.launches_by_route)
    failures = [f for c in card.values() for f in c.failures]
    emit({"phase": "checks", "device": str(dev),
          "passed": {m.split(".")[-1]: len(c.names) - len(c.failures)
                     for m, c in card.items()},
          "failed": failures[:20],
          "names_equal_cpu": {m.split(".")[-1]: c.names == cpu[m]
                              for m, c in card.items()},
          "launches": launches, "flash_launches_by_route": routes,
          "card_s": card_s, "cpu_s": cpu_s})
    require(not failures, f"checks failed on the card: {failures[:20]}")
    for m, c in card.items():
        require(c.names == cpu[m] and c.names,
                f"{m}: the card's check names differ from the CPU's")
    for name in IO_KERNELS:
        require(launches[name] > 0, f"checks: {name} never launched")
    return launches, routes


@contextlib.contextmanager
def perf_opts_off():
    """``REPRO_PERF_OPTS=0`` inside the block (the model's attention and
    the kernels take their f32 p.v variant), the old value after it."""
    old = os.environ.get("REPRO_PERF_OPTS")
    os.environ["REPRO_PERF_OPTS"] = "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("REPRO_PERF_OPTS")
        else:
            os.environ["REPRO_PERF_OPTS"] = old


# the f32 p.v variant: f32 inputs within this relative L2 distance of the
# plain version under the setting (the default variant's bf16 p and v
# leave about 2e-3 and must fail it); bf16 inputs within ATTN_TOL and
# with at least this share of output elements bit-equal to the plain
# output (which rounds its f32 result to bf16 once), more than the
# default variant's share, which must miss it
PV32_REL_L2 = 1e-4
PV32_BF16_SHARE = 0.95
# FLASH_CASES that reach each route, in the type their path runs
PV32_CASES = (("prefill_global", "bfloat16"),
              ("prefill_global_nocap", "bfloat16"),
              ("kimi_prefill", "bfloat16"), ("decode", "bfloat16"),
              ("kimi_decode_b1", "bfloat16"),
              ("whisper_encoder", "float32"), ("train_global", "float32"))
PV32_LIBRARY = {"sdpa": "F.scaled_dot_product_attention in f32 (the "
                        "inputs converted to f32; enable_gqa)",
                "flex": FLEX + ", in f32 (the inputs converted to f32)"}


def bit_share(torch, got, want) -> float:
    """The share of elements whose bits equal ``want``'s."""
    return float((bits(torch, got) == bits(torch, want)).float().mean())


def sdpa_f32_library(torch, q, k, v, kw, want, reps, flush) -> dict:
    """SDPA in f32 (no softcap): the same function as the f32 p.v
    variant. Held to the plain version at the f32 limit and timed."""
    fn = _sdpa_no_softcap(torch, q, k, v, kw["causal"], kw["window"],
                          kw["q_offset"], kw["kv_len"])
    check = attn_err(fn().transpose(1, 2), want, ATTN_TOL["float32"])
    ms = time_ms(torch, fn, reps, flush)
    if check["within"]:
        return {"library_ms": ms, "library": PV32_LIBRARY["sdpa"]}
    return {"library_ms": None, "library": PV32_LIBRARY["sdpa"]
            + f": outside the f32 limits ({check})"}


def pv32_case(torch, dev, gen, name, dname, reps, flush) -> dict:
    """One ``PV32_CASES`` case with the setting off: the call through
    ``ops.fused_attention`` (which takes the variant from the setting)
    against ``flash_attention_ref`` (which follows it), the default
    variant on the same inputs as a planted fault, and the times of
    both, of the plain version and of the library's f32 call."""
    from repro_torch.kernels import flash, ops, ref
    _, b, sq, skv, causal, window, q_offset, kv_len, cap = next(
        c for c in FLASH_CASES if c[0] == name)
    hq, hkv, hd = FLASH_HEADS.get(name, (16, 8, 256))
    dtype = getattr(torch, dname)
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
               for s in ((b, sq, hq, hd), (b, skv, hkv, hd),
                         (b, skv, hkv, hd)))
    kw = dict(causal=causal, window=window, logit_cap=cap,
              q_offset=q_offset, kv_len=kv_len)
    route = flash._route(b, sq, hq, hkv, hd, dtype) + "_pv32"
    counts = dict(flash.flash_attention_fused.launches_pv32)
    got = ops.fused_attention(q, k, v, **kw)
    counts[route] += 1
    require(flash.flash_attention_fused.launches_pv32 == counts,
            f"pv32 {name} {dname}: launched "
            f"{flash.flash_attention_fused.launches_pv32}, not one {route}")
    want = ref.flash_attention_ref(q, k, v, **kw)
    default = flash.flash_attention_ragged(q, k, v, pv32=False, **kw)
    check = attn_err(got, want, ATTN_TOL[dname])
    planted = attn_err(default, want, ATTN_TOL[dname])
    rec = {"case": name, "dtype": dname, "route": route, "q": list(q.shape),
           "kv": list(k.shape), "causal": causal, "window": window,
           "logit_cap": cap, "max_abs_err": check["max_abs_err"],
           "rel_l2": check["rel_l2"], "default_rel_l2": planted["rel_l2"],
           "default_max_abs_err": planted["max_abs_err"]}
    if dtype == torch.float32:
        ok = check["within"] and check["rel_l2"] <= PV32_REL_L2
        fault_passes = planted["rel_l2"] <= PV32_REL_L2
        rec["tol_rel_l2"] = PV32_REL_L2
    else:
        share, share_default = bit_share(torch, got, want), \
            bit_share(torch, default, want)
        ok = check["within"] and share >= PV32_BF16_SHARE \
            and share > share_default
        fault_passes = share_default >= PV32_BF16_SHARE
        rec.update(bit_equal_share=share, default_bit_equal_share=share_default,
                   tol_share=PV32_BF16_SHARE)
    del got, default, want
    bound_ms, bound_by, pairs, _ = attention_bound(
        torch, q.shape, k.shape, q.element_size(), causal, window, q_offset,
        kv_len, pv32=True)
    rec.update(
        ms=time_ms(torch, lambda: ops.fused_attention(q, k, v, **kw), reps,
                   flush),
        default_ms=time_ms(torch, lambda: flash.flash_attention_ragged(
            q, k, v, pv32=False, **kw), reps, flush),
        plain_ms=time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, **kw),
                         max(2, reps // 4), flush),
        bound_ms=bound_ms, bound_by=bound_by, pairs=pairs)
    qf, kf, vf = (x.float() for x in (q, k, v))
    want32 = ref.flash_attention_ref(qf, kf, vf, **kw)
    if cap is None:
        rec.update(sdpa_f32_library(torch, qf, kf, vf, kw, want32, reps,
                                    flush))
    else:
        lib = flex_library(torch, qf, kf, vf, kw, want32, ATTN_TOL["float32"],
                           reps, flush)
        rec.update(lib, library=lib["library"].replace(
            FLEX, PV32_LIBRARY["flex"]))
    del q, k, v, qf, kf, vf, want32
    torch.cuda.empty_cache()
    emit({"phase": "kernel", "kernel": "flash_attention_fused",
          "variant": "pv32", **rec})
    require(ok, f"pv32 {name} {dname}: {rec}")
    require(not fault_passes, f"pv32 {name} {dname}: the default variant "
            f"passes the f32 p.v check: {rec}")
    return rec


PV32_BWD_LIBRARY = ("the backward of " + FLEX + ", in f32, by "
                    "torch.autograd.grad of a forward taken before the "
                    "timer")


def flex_bwd_library(torch, q, k, v, dout, kw, want, reps, flush) -> dict:
    """``library_ms`` of the backward's f32 p.v variant: the backward of
    compiled ``flex_attention`` on the same f32 inputs (the softcap as
    its ``score_mod``, the masks as its block mask), the same function:
    its gradients held to ``want`` (``flash_attention_bwd_ref`` with an
    f32 p.v) at ``BWD_TOL``, then ``torch.autograd.grad`` of a forward
    taken before the timer is timed (compiled without donated buffers,
    which a backward run again on the kept graph needs). Where it does
    not compile or disagrees the reason is kept and ``library_ms`` is
    null."""
    import torch._functorch.config
    try:
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        fn = _flex_same_fn(torch, *leaves, kw["causal"], kw["window"],
                           kw["q_offset"], kw["kv_len"], kw["logit_cap"])

        def grads():
            return torch.autograd.grad(out, leaves, dout, retain_graph=True)
        with torch._functorch.config.patch(donated_buffer=False):
            with torch.enable_grad():
                out = fn()
            check = grads_err(grads(), want, "float32")
            ms = time_ms(torch, grads, reps, flush)
    except Exception as exc:   # a measurement of the library, not the port
        return {"library_ms": None,
                "library": f"{PV32_BWD_LIBRARY}: failed: "
                           f"{type(exc).__name__}: {str(exc)[:300]}"}
    rec = {"flex_ms": ms, "flex_max_abs_err": check["max_abs_err"],
           "flex_rel_l2": {n: c["rel_l2"]
                           for n, c in check["per_grad"].items()}}
    if check["within"]:
        return {**rec, "library_ms": ms, "library": PV32_BWD_LIBRARY}
    return {**rec, "library_ms": None,
            "library": f"{PV32_BWD_LIBRARY}: outside BWD_TOL"}


def pv32_backward(torch, dev, reps, flush) -> dict:
    """The backward's f32 p.v variant at ``train_global`` in f32 (the
    training path's global layer, q and k of std 2) against
    ``flash_attention_bwd_ref`` with the setting off, under ``BWD_TOL``;
    the default variant's gradient (a planted fault) must fail it. Its
    library time is ``flex_attention``'s backward (``flex_bwd_library``)."""
    from repro_torch.kernels import flash, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    b, s, hq, hkv, hd = TRAIN_BATCH, TRAIN_SEQ, 16, 8, 256
    q, k = ((2 * torch.randn(sh, generator=gen, device=dev))
            for sh in ((b, s, hq, hd), (b, s, hkv, hd)))
    v = torch.randn((b, s, hkv, hd), generator=gen, device=dev)
    dout = torch.randn((b, s, hq, hd), generator=gen, device=dev)
    kw = dict(causal=True, window=None, logit_cap=50.0, q_offset=0,
              kv_len=None)
    out = ref.flash_attention_ref(q, k, v, **kw)
    before = flash.flash_attention_bwd.launches_pv32["bwd_pv32"]
    got = flash.flash_attention_bwd(q, k, v, out, dout, pv32=True, **kw)
    require(flash.flash_attention_bwd.launches_pv32["bwd_pv32"]
            == before + 1, "pv32 bwd: not launched once")
    want = ref.flash_attention_bwd_ref(q, k, v, out, dout, **kw)
    check = grads_err(got, want, "float32")
    planted = grads_err(flash.flash_attention_bwd(
        q, k, v, out, dout, pv32=False, **kw), want, "float32")
    library = flex_bwd_library(torch, q, k, v, dout, kw, want, reps, flush)
    del got, want
    bound_ms, bound_by, pairs, _ = bwd_bound(torch, q.shape, k.shape, 4,
                                             True, None)
    rec = {"case": "train_global", "dtype": "float32", "variant": "pv32",
           "q": list(q.shape), "kv": list(k.shape),
           "max_abs_err": check["max_abs_err"], "grads": check["per_grad"],
           "tol": BWD_TOL["float32"],
           "default_rel_l2": {n: c["rel_l2"]
                              for n, c in planted["per_grad"].items()},
           "ms": time_ms(torch, lambda: flash.flash_attention_bwd(
               q, k, v, out, dout, pv32=True, **kw), reps, flush),
           "default_ms": time_ms(torch, lambda: flash.flash_attention_bwd(
               q, k, v, out, dout, pv32=False, **kw), reps, flush),
           "plain_ms": time_ms(torch, lambda: ref.flash_attention_bwd_ref(
               q, k, v, out, dout, **kw), 2, flush),
           "bound_ms": bound_ms, "bound_by": bound_by, "pairs": pairs}
    rec.update(library)
    emit({"phase": "kernel", "kernel": "flash_attention_bwd", **rec})
    require(check["within"], f"pv32 bwd: {check}")
    require(not planted["within"], "pv32 bwd: the default variant passes")
    del q, k, v, out, dout
    torch.cuda.empty_cache()
    return rec


def pv32_train_step(torch, dev, tmp) -> tuple:
    """A training step of the training phase's model (gemma2-9b at full
    width cut to ``TRAIN_LAYERS`` layers, f32, batch ``TRAIN_BATCH`` x
    ``TRAIN_SEQ``) through ``launch.train.build_training``'s step with
    the setting off, after a warm-up step: launch counts set to 0 just
    before it and read just after; the attention's forward must run on
    ``tc_f32_pv32`` and its backward on ``bwd_pv32``, and the loss must
    equal the same model's loss with attention forced through the plain
    version (under the setting) within ``TRAIN_LOSS_REL``. Returns the
    record, its launches, its flash routes and its f32 p.v counts."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels import flash, ref
    from repro_torch.launch.train import build_training
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(configs.get("gemma2_9b"), n_layers=TRAIN_LAYERS)
    run = build_training("gemma2_9b", cfg=cfg, steps=2, batch=TRAIN_BATCH,
                         seq=TRAIN_SEQ, lr=3e-3, ckpt_dir=tmp, device=dev)
    batch = run.data.batch_at(0)
    run.train_step(run.params, run.opt_state, batch)          # warm-up
    (_, _, loss), ms, launches, routes, peak = counted(
        torch, dev, lambda: run.train_step(run.params, run.opt_state, batch))
    pv32 = {**flash.flash_attention_fused.launches_pv32,
            **flash.flash_attention_bwd.launches_pv32}
    with torch.no_grad(), patched_attention(
            layers, lambda _: ref.flash_attention_ref):
        plain = T.loss_fn(run.params, cfg, batch)
    loss, plain = float(loss), float(plain)
    rec = {"phase": "perf_opts_train_step", "layers": TRAIN_LAYERS,
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "loss": loss,
           "loss_plain_attention": plain,
           "rel_diff": abs(loss - plain) / abs(plain), "ms": ms,
           "peak_mem_bytes": peak, "launches_pv32": pv32,
           "flash_launches_by_route": routes}
    emit(rec)
    require(math.isfinite(loss) and rec["rel_diff"] <= TRAIN_LOSS_REL,
            f"pv32 train step: {rec}")
    n = TRAIN_LAYERS   # one forward and one backward launch a layer
    require(pv32["tc_f32_pv32"] == routes["tc_f32"] == n
            and pv32["bwd_pv32"] == launches["flash_attention_bwd"] == n,
            f"pv32 train step: launches {pv32}, routes {routes}")
    del run, batch
    torch.cuda.empty_cache()
    return rec, launches, routes, pv32


def phase_perf_opts(torch, dev, reps, tmp):
    """``REPRO_PERF_OPTS=0``, set and restored inside the phase: every
    ``PV32_CASES`` case (``pv32_case``), the backward at the training
    shape (``pv32_backward``) and a main-path training step
    (``pv32_train_step``). Returns the cases, the backward's line, and
    the training step's launches, flash routes and f32 p.v counts (the
    serve phase's f32 p.v generate is in ``phase_serve``)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    flush = torch.empty(1 << 25, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    with perf_opts_off():
        cases = [pv32_case(torch, dev, gen, name, dname, reps, flush)
                 for name, dname in PV32_CASES]
        bwd = pv32_backward(torch, dev, reps, flush)
        del flush
        _, launches, routes, pv32 = pv32_train_step(torch, dev, tmp)
    emit({"phase": "perf_opts", "seconds": time.perf_counter() - t0,
          "cases": len(cases), "restored": os.environ.get("REPRO_PERF_OPTS")})
    return cases, bwd, launches, routes, pv32


def main() -> int:
    t_start = time.perf_counter()
    # torch.compile (flex_attention's library time) keeps its caches in
    # the checkout and compiles in this process
    for var, val in (("TORCHINDUCTOR_CACHE_DIR", ROOT / "build" / "inductor"),
                     ("TRITON_CACHE_DIR", ROOT / "build" / "triton"),
                     ("TORCHINDUCTOR_COMPILE_THREADS", 1)):
        os.environ.setdefault(var, str(val))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    load_peaks()
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    lib_path, build_s = build.build_library()
    build.load_library()
    ptxas = []
    for log in sorted(build.build_dir().glob("*.log")):
        ptxas += [ln.strip() for ln in log.read_text().splitlines()
                  if "registers" in ln or "Compiling entry" in ln
                  or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "library": lib_path.name,
          "ptxas": ptxas, "sass": sass_counts(build._nvcc(), lib_path)})
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    measured = phase_kernels(torch, dev, REPS)
    measured["pack"] = phase_pack(torch, dev, REPS)
    measured["route_spans"] = phase_route_spans(torch, dev, REPS)
    measured["flash_attention_fused"] = phase_flash(torch, dev, REPS)
    phase_small(torch, dev)
    phase_small_codecs(torch, dev)
    launches = phase_main(torch, dev)
    patterns = phase_patterns(torch, dev)
    hosted, pack_rec = phase_host(torch, dev, REPS)
    phase_mp(torch, dev)
    checked, checked_routes = phase_checks(torch, dev)
    served, served_routes, served_pv32 = phase_serve(torch, dev)
    moe, moe_routes = phase_serve_moe(torch, dev)
    phase_collectives(torch, dev)
    piped, piped_routes = phase_pipeline(torch, dev)
    ssm, ssm_routes = phase_serve_ssm(torch, dev)
    vlm, vlm_routes = phase_serve_vlm(torch, dev)
    audio, audio_routes = phase_serve_audio(torch, dev)
    measured["flash_attention_bwd"] = phase_train_kernel(torch, dev, REPS)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        pv32_cases, pv32_bwd, pv32_launches, pv32_routes, pv32_counts = \
            phase_perf_opts(torch, dev, REPS, os.path.join(tmp, "pv32"))
        trained, trained_routes, train_pack, ckpt = phase_train(torch, dev,
                                                                tmp)
        restored, restored_routes = phase_serve_restore(torch, dev, ckpt)
        del ckpt
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    roofed, roofed_routes = phase_roofline(torch, dev, smi)
    runs = (served, moe, piped, ssm, vlm, audio, trained, restored, roofed,
            checked, pv32_launches)
    launches = {k: launches[k] + patterns[k] + hosted[k]
                + sum(r[k] for r in runs) for k in launches}
    routes = {r: sum(rr[r] for rr in (
        served_routes, moe_routes, piped_routes, ssm_routes, vlm_routes,
        audio_routes, trained_routes, restored_routes, roofed_routes,
        pv32_routes, checked_routes))
        for r in served_routes}
    # the f32 p.v variants' launches on the main paths (REPRO_PERF_OPTS=0:
    # the serve phase's generate and perf_opts' training step)
    launches_pv32 = {**{r: served_pv32[r] + pv32_counts[r]
                        for r in served_pv32},
                     "bwd_pv32": pv32_counts["bwd_pv32"]}
    for variant, n in launches_pv32.items():
        require(n > 0, f"{variant}: the f32 p.v variant never launched")
    require(sum(routes.values()) == launches["flash_attention_fused"],
            f"flash routes {routes} vs {launches['flash_attention_fused']}")
    # pack's line: its largest shape, a window of a training save's
    # domain image; the host path's and the drain window's cases beside
    case_keys = ("shape", "out_len", "max_abs_err", "ms", "plain_ms",
                 "bound_ms")
    window_case = measured["pack"]
    measured["pack"] = train_pack
    require(hosted["pack"] > 0, "host: pack never launched")
    flash_rec = measured["flash_attention_fused"]
    extra = {"flash_attention_fused": {   # beyond the contract's keys
        "sources": FLASH_SOURCES, "case": flash_rec["case"],
        "kernel_route": flash_rec["route"],
        "library": flash_rec["library"],
        "nocap_case": flash_rec["nocap_case"],
        "kimi_cases": flash_rec["kimi_cases"],
        "vlm_audio_cases": flash_rec["vlm_audio_cases"],
        "f32_cases": flash_rec["f32_cases"],
        "launches_by_route": routes,
        "launches_pv32": {r: launches_pv32[r] for r in served_pv32},
        "pv32_cases": [{k: c.get(k) for k in (
            "case", "dtype", "route", "ms", "default_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library", "max_abs_err",
            "rel_l2", "bit_equal_share", "default_bit_equal_share")}
            for c in pv32_cases]},
        "pack": {"path": "a training save's domain image (phase_train)",
                 "shape": train_pack["shape"],
                 "out_len": train_pack["out_len"],
                 "plain_chunk": train_pack["plain_chunk"],
                 "host_case": {k: pack_rec[k] for k in case_keys},
                 "window_case": {k: window_case[k] for k in case_keys}}}
    for what, n in (("serve", served), ("serve_moe", moe),
                    ("pipeline", piped), ("serve_vlm", vlm),
                    ("serve_audio", audio)):
        require(n["flash_attention_fused"] > 0,
                f"{what}: flash_attention_fused never launched")
    bwd_rec = measured["flash_attention_bwd"]
    extra["flash_attention_bwd"] = {
        "path": "training (phase_train): every backward of every layer",
        "case": bwd_rec["case"], "other_cases": bwd_rec["other_cases"],
        "passes_ms": bwd_rec["passes_ms"],
        "achieved_tflops": bwd_rec["achieved_tflops"],
        "issued_tflops": bwd_rec["issued_tflops"],
        "f32_cores_bound_ms": bwd_rec["f32_cores_bound_ms"],
        "library": bwd_rec["library"],
        "launches_pv32": {"bwd_pv32": launches_pv32["bwd_pv32"]},
        "pv32_case": {k: pv32_bwd[k] for k in (
            "case", "ms", "default_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library", "max_abs_err")}}

    emit({"phase": "kernel_status",
          "table": [{"name": n, "replaces": r, "status": s,
                     "launches": launches.get(n, 0),
                     **({"note": NOTES[n]} if n in NOTES else {})}
                    for n, r, s in TABLE]})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
         "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
         "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
         **extra.get(name, {})}
        for name, rec in measured.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
