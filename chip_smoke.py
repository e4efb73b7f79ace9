#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version at the shapes the
main path gives it (exact equality: the write moves 4-byte words and
does no arithmetic on them), checks small writes and reads with every
slow-hop codec on the card against the CPU, then drives the main path
on the BTIO deployment (16 nodes x 64 ranks, one global aggregator per
node, a 512 MiB file, 32 rounds of 1 MiB windows) with
``kernel_fusion="fused_round"``:

* the two-phase and the TAM collective write (``make_twophase_write``,
  ``make_tam_write(use_kernels=True)``);
* the same two writes with ``slow_hop_codec="rle"`` on a payload whose
  8-element cells are half zero (a sparse checkpoint page), whose wire
  the zero-skip kernels encode and decode;
* the two-phase and the TAM collective read with ``"rle"``
  (``make_twophase_read``, ``make_tam_read``), reading that file back.

Every phase prints one JSON line; any failed check raises, and the run
exits non-zero. The line before the last lists every kernel with its
launches on the main path, its time, its bound and the plain and library
times; the last line is ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the repository's ``src/`` beside it, the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
REPS = 10                     # timed runs per kernel measurement
FP32_OPS_PER_S = 67e12        # H100 SXM non-tensor float32 rate; no
                              # int32 row in the table, used for compares
REPLACES = {
    "bitonic_sort": "src/repro/kernels/sort.py:72",
    "coalesce": "src/repro/kernels/coalesce_kernel.py:73",
    "fused_sort_pack": "src/repro/kernels/fused_round.py:64",
    "zero_skip_encode": "src/repro/kernels/fused_round.py:129",
    "zero_skip_decode": "src/repro/kernels/fused_round.py:172",
}
SOURCES = {
    "bitonic_sort": "src/repro_torch/kernels/csrc/sort.cu",
    "coalesce": "src/repro_torch/kernels/csrc/coalesce_kernel.cu",
    "fused_sort_pack": "src/repro_torch/kernels/csrc/fused_round.cu",
    "zero_skip_encode": "src/repro_torch/kernels/csrc/zero_skip.cu",
    "zero_skip_decode": "src/repro_torch/kernels/csrc/zero_skip.cu",
}
TABLE = (   # every pallas_call of the reference, by def line
    ("fused_sort_pack", "src/repro/kernels/fused_round.py:64", "ported"),
    ("bitonic_sort", "src/repro/kernels/sort.py:72", "ported"),
    ("coalesce", "src/repro/kernels/coalesce_kernel.py:73", "ported"),
    ("zero_skip_encode", "src/repro/kernels/fused_round.py:129", "ported"),
    ("zero_skip_decode", "src/repro/kernels/fused_round.py:172", "ported"),
    ("pack", "src/repro/kernels/pack.py:56", "to_port"),
    ("flash_attention_fused", "src/repro/kernels/flash.py:92", "to_port"),
)


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
    path does."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
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


def sparse_rows(torch, rows, n, gen, dev):
    """Nonzero int32 rows in which half of the 8-element cells are zero
    (a sparse checkpoint page, the payload the rle codec exists for)."""
    x = torch.randint(1, 2**31 - 1, (rows, n), generator=gen, device=dev,
                      dtype=torch.int32)
    keep = torch.rand(rows, n // 8, 1, generator=gen, device=dev) < 0.5
    x.view(rows, n // 8, 8).mul_(keep)
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
        rec = {"shape": [rows, n], "max_abs_err": err,
               "ms": timed(lambda: sort.bitonic_sort(o, ln, c)),
               "plain_ms": timed(lambda: ref.sort_ref(o, ln, c)),
               "library_ms": timed(
                   lambda: torch.sort(o, dim=1, stable=True)),
               "bound_ms": b, "bound_by": by}
        emit({"phase": "kernel", "kernel": "bitonic_sort", **rec})
        results.setdefault("bitonic_sort", rec)

    rows, n = 16, 32768
    o, ln = coalesce_inputs(torch, rows, n, 2048, gen, dev)
    got = coalesce_kernel.coalesce(o, ln)
    err = max_abs_err(torch, got, ref.coalesce_ref(o, ln))
    require(err == 0, "coalesce [16, 32768] != coalesce_ref")
    b, by = bound((4 * rows * n + rows) * 4, rows * n * 4)
    rec = {"shape": [rows, n], "max_abs_err": err,
           "runs": int(got[2].sum().item()),
           "ms": timed(lambda: coalesce_kernel.coalesce(o, ln)),
           "plain_ms": timed(lambda: ref.coalesce_ref(o, ln)),
           "library_ms": None, "bound_ms": b, "bound_by": by}
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
        b, by = bound(3 * rows * cap * 4 + covered * 4
                      + 2 * rows * out_len * 4,
                      rows * cap * math.log2(cap)
                      + rows * out_len * math.log2(cap))
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
    # [16, 262144]; encode reads n words and writes 2n, decode the reverse
    for rows, n in ((16384, 131072), (256, 262144), (16, 262144)):
        x = sparse_rows(torch, rows, n, gen, dev)
        chunk = max(1, (1 << 27) // n)   # the plain versions' int64 temps
        spans = [slice(i, i + chunk) for i in range(0, rows, chunk)]
        vals, pos = fused_round.zero_skip_encode(x)
        err_e = max(max_abs_err(torch, (vals[c], pos[c]),
                                ref.zero_skip_encode_ref(x[c]))
                    for c in spans)
        require(err_e == 0, f"zero_skip_encode [{rows}, {n}] != plain")
        b, by = bound(12 * rows * n, 2 * rows * n)
        rec = {"shape": [rows, n], "nonzero": int((x != 0).sum().item()),
               "max_abs_err": err_e,
               "ms": timed(lambda: fused_round.zero_skip_encode(x)),
               "plain_ms": timed(lambda: [ref.zero_skip_encode_ref(x[c])
                                          for c in spans],
                                 max(2, reps // 4)),
               "library_ms": None, "bound_ms": b, "bound_by": by}
        emit({"phase": "kernel", "kernel": "zero_skip_encode", **rec})
        results.setdefault("zero_skip_encode", rec)

        out = fused_round.zero_skip_decode(vals, pos)
        require(torch.equal(out, x), f"zero_skip [{rows}, {n}] round trip")
        del x
        err_d = max(max_abs_err(torch, (out[c],),
                                (ref.zero_skip_decode_ref(vals[c],
                                                          pos[c]),))
                    for c in spans)
        require(err_d == 0, f"zero_skip_decode [{rows}, {n}] != plain")
        del out
        torch.cuda.empty_cache()
        b, by = bound(12 * rows * n, rows * n)
        rec = {"shape": [rows, n], "max_abs_err": err_d,
               "ms": timed(lambda: fused_round.zero_skip_decode(vals, pos)),
               "plain_ms": timed(lambda: [ref.zero_skip_decode_ref(
                   vals[c], pos[c]) for c in spans], max(2, reps // 4)),
               "bound_ms": b, "bound_by": by}
        # library: one scatter_ into a zeroed [rows, n + 1] buffer whose
        # last column takes pos -1 (index prepared outside the timing)
        idx = torch.where(pos >= 0, pos, n).to(torch.int64)
        stage = torch.empty((rows, n + 1), dtype=vals.dtype, device=dev)
        rec["library_ms"] = timed(
            lambda: stage.zero_().scatter_(1, idx, vals))
        emit({"phase": "kernel", "kernel": "zero_skip_decode", **rec})
        results.setdefault("zero_skip_decode", rec)
        del vals, pos, idx, stage
        torch.cuda.empty_cache()
    del flush
    return results


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
    (and the 5e-2 band against ``write_reference``) for ef-int8."""
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
    emit({"phase": "small_codecs_vs_cpu", **counts, "ok": True})


STALL = "Command Buffer Full"   # the profiler's record of a blocked launch


def _union_us(spans) -> float:
    """Total length of the union of ``(start, end)`` spans."""
    total, reach = 0.0, -math.inf
    for s, e in sorted(spans):
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total


# round-engine steps timed by CUDA events in the profiled runs: the
# exchange and drain of every write round (_run_rounds' closures) and,
# inside them, the routing helpers and kernel wrappers they call; a read
# has no exchange/drain pair, only its index set-up (repeat_index) and
# the rle wrappers inside its fetch
STEPS = {"repro_torch.core.rounds": ("_compact_active", "repack_sorted",
                                     "bucket_by_dest", "flatten_buckets",
                                     "sort_with", "_a2a", "repeat_index"),
         "repro_torch.kernels.ops": ("sort_requests_with", "coalesce",
                                     "fused_drain_pack",
                                     "rle_zero_skip_encode",
                                     "rle_zero_skip_decode")}
PORT_KERNELS = ("sort_rows_kernel", "coalesce_rows_kernel",
                "pack_tiles_kernel", "zero_skip_encode_kernel",
                "zero_skip_decode_kernel")


@contextlib.contextmanager
def step_timers(torch, totals):
    """Wrap the round engine's steps so that each call records a CUDA
    event before and after it; on exit, ``totals[step]`` holds the
    summed event time (ms) and the call count. The stream is one queue
    that the host keeps full (the idle share is small), so an event
    pair spans the device time of the work enqueued between them."""
    import importlib
    rounds = importlib.import_module("repro_torch.core.rounds")
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

    def run_rounds(n, buf, exchange, drain, depth, codec_state=()):
        return saved[0][2](n, buf, timed("exchange", exchange),
                           timed("drain", drain), depth, codec_state)

    saved.append((rounds, "_run_rounds", rounds._run_rounds))
    rounds._run_rounds = run_rounds
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
    the port's kernels' device time, the device time of each round-engine
    step (``step_timers``) and the PyTorch operators whose kernels took
    the most device time."""
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
        if e.device_type != DeviceType.CUDA:
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
        fn(*args)                        # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches[name] = kernels.launch_counts()
        runs[name] = (fn, args)
        return out, {"wall_s": wall,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
                     "launches": launches[name]}

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

    for name, (fn, args) in runs.items():   # after the counts are read
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


def main() -> int:
    t_start = time.perf_counter()
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
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    lib_path, build_s = build.build_library()
    build.load_library()
    ptxas = []
    for log in sorted(build.build_dir().glob("*.log")):
        ptxas += [ln.strip() for ln in log.read_text().splitlines()
                  if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": build_s, "library": lib_path.name,
          "ptxas": ptxas})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    measured = phase_kernels(torch, dev, REPS)
    phase_small(torch, dev)
    phase_small_codecs(torch, dev)
    launches = phase_main(torch, dev)

    emit({"phase": "kernel_status",
          "table": [{"name": n, "replaces": r, "status": s,
                     "launches": launches.get(n, 0)} for n, r, s in TABLE]})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
         "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
         "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
        for name, rec in measured.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
