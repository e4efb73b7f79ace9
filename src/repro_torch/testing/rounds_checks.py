"""Round-engine checks (the port of ``src/repro/testing/rounds_checks.py``).

    python -m repro_torch.testing.rounds_checks [--device cpu|cuda]

The reference's properties, under its check names, on the rank-axis
executor (8 ranks on a ``(node 2, lagg 2, lmem 2)`` grid, one device):

* for round counts {1, 2, 5} (cb_buffer_size in {160, 80, 32} on a
  160-element domain) and the mixed, strided, overlapping and spanning
  patterns, the multi-round two-phase and TAM writes are byte-identical
  to both the single shot and the ``write_reference`` oracle with zero
  drops; the pipelined ring equals the serial one and the oracle;
* the depth-k ring (k in {3, 4}) at every round count for two-phase
  (the 1-round rows exercise the depth clamp) and at 5 rounds for TAM;
* the round-scheduled reads (serial, pipelined, depth k) return every
  rank's payload;
* ``slow_hop_codec="rle"`` at depths {1, 2, 4}, an rle read, and the
  swapped placement ``(1, 0)`` for writes and a read;
* fused (``kernel_fusion="fused_round"``) against unfused reads, for
  every codec x depth pair under the swapped placement;
* ``fuzz0`` to ``fuzz3``: seeded random patterns through the rank-axis
  writers (placement x codec x depth, each also fused), the host
  executor (placement x codec x depth, a TAM write, a unified-config
  write, and the planned reads with the node cache on and off) and, for
  seed 0, the mp executor's worker processes; every file equal to the
  oracle's bytes;
* a deliberately overflowed round bucket reports ``dropped_elems > 0``.

TAM writes run with ``use_kernels=True`` (on the card: the
``bitonic_sort`` and ``coalesce`` kernels; on the CPU their plain
versions, which equal the executor's own sort and coalesce). The
patterns are the reference's numpy generators with its seeds.
"""
from __future__ import annotations

import sys
import tempfile
from dataclasses import replace

import numpy as np

from repro_torch.testing import Checks, cli

P_RANKS, REQ_CAP, DATA_CAP, FILE_LEN = 8, 8, 64, 320
CBS = (160, 80, 32)   # domain_len=160 -> 1, 2, 5 rounds
DEPTHS = (3, 4)       # ring depths beyond the serial/pipelined rows
CODEC_DEPTHS = (1, 2, 4)
SWAP = (1, 0)


def mixed_pattern(rng):
    """Random disjoint extents, random lengths, shuffled ownership."""
    O = np.full((P_RANKS, REQ_CAP), 2**31 - 1, np.int32)
    L = np.zeros((P_RANKS, REQ_CAP), np.int32)
    C = np.zeros(P_RANKS, np.int32)
    D = np.zeros((P_RANKS, DATA_CAP), np.int32)
    slots = rng.permutation(FILE_LEN // 8)
    spr = len(slots) // P_RANKS
    for p in range(P_RANKS):
        mine = np.sort(slots[p * spr:(p + 1) * spr])[:6]
        lens = rng.integers(1, 9, size=len(mine)).astype(np.int32)
        O[p, :len(mine)], L[p, :len(lens)] = (mine * 8).astype(np.int32), lens
        C[p] = len(mine)
        D[p, :lens.sum()] = rng.integers(1, 999, size=lens.sum())
    return O, L, C, D


def strided_pattern(rng):
    """E3SM-style round-robin interleave: rank r owns slots r, r+P, ..."""
    O = np.full((P_RANKS, REQ_CAP), 2**31 - 1, np.int32)
    L = np.zeros((P_RANKS, REQ_CAP), np.int32)
    C = np.full(P_RANKS, REQ_CAP, np.int32)
    D = np.zeros((P_RANKS, DATA_CAP), np.int32)
    unit = FILE_LEN // (P_RANKS * REQ_CAP)  # 5 elements per request
    for p in range(P_RANKS):
        idx = np.arange(REQ_CAP, dtype=np.int32)
        O[p] = (idx * P_RANKS + p) * unit
        L[p] = unit
        D[p, :REQ_CAP * unit] = O[p].repeat(unit) % 97 + 1
    return O, L, C, D


def overlapping_pattern(rng):
    """Ranks 0 and 1 write identical data to the same two regions;
    ranks 2..7 write disjoint extents elsewhere (sized so TAM's
    duplicated stage-1 payload fits the smallest round bucket)."""
    O = np.full((P_RANKS, REQ_CAP), 2**31 - 1, np.int32)
    L = np.zeros((P_RANKS, REQ_CAP), np.int32)
    C = np.zeros(P_RANKS, np.int32)
    D = np.zeros((P_RANKS, DATA_CAP), np.int32)
    span, regions = 12, (8, 280)
    for p in (0, 1):
        for i, o in enumerate(regions):
            O[p, i], L[p, i] = o, span
            D[p, i * span:(i + 1) * span] = np.arange(o, o + span) % 97 + 1
        C[p] = 2
    for p in range(2, P_RANKS):
        o = 40 + (p - 2) * 24 if p <= 4 else 170 + (p - 5) * 24
        O[p, 0], L[p, 0], C[p] = o, 20, 1
        D[p, :20] = rng.integers(1, 999, size=20)
    return O, L, C, D


def spanning_pattern(rng):
    """Requests crossing the file-domain boundary at 160 and a cb=32
    window boundary: both paths must split them."""
    O = np.full((P_RANKS, REQ_CAP), 2**31 - 1, np.int32)
    L = np.zeros((P_RANKS, REQ_CAP), np.int32)
    C = np.zeros(P_RANKS, np.int32)
    D = np.zeros((P_RANKS, DATA_CAP), np.int32)
    O[0, 0], L[0, 0], C[0] = 150, 24, 1          # [150, 174)
    D[0, :24] = np.arange(150, 174) % 97 + 1
    O[1, 0], L[1, 0], C[1] = 250, 12, 1          # domain-local [90, 102)
    D[1, :12] = np.arange(250, 262) % 97 + 1
    for p in range(2, P_RANKS):
        o = 8 + (p - 2) * 16
        O[p, 0], L[p, 0], C[p] = o, 12, 1
        D[p, :12] = rng.integers(1, 999, size=12)
    return O, L, C, D


def _fill_sorted(O, L, C, D, p, segs):
    """Rank p's segments sorted by offset, payload derived from the
    absolute offset (any overlap is identical-data)."""
    segs = sorted(segs)
    pos = 0
    for i, (o, ln) in enumerate(segs):
        O[p, i], L[p, i] = o, ln
        D[p, pos:pos + ln] = (np.arange(o, o + ln) * 7 + 3) % 251 + 1
        pos += ln
    C[p] = len(segs)


def random_pattern(rng):
    """The file cut at random points, the pieces dealt to random ranks
    (bounded by the caps), offset-derived payloads; about 1 pattern in 4
    duplicates a piece onto a second rank; pieces straddle domain and
    window boundaries freely."""
    O = np.full((P_RANKS, REQ_CAP), 2**31 - 1, np.int32)
    L = np.zeros((P_RANKS, REQ_CAP), np.int32)
    C = np.zeros(P_RANKS, np.int32)
    D = np.zeros((P_RANKS, DATA_CAP), np.int32)
    cuts = np.unique(rng.integers(1, FILE_LEN, size=rng.integers(8, 28)))
    bounds = np.concatenate([[0], cuts, [FILE_LEN]])
    per_rank: list[list] = [[] for _ in range(P_RANKS)]
    budget = np.zeros(P_RANKS, np.int64)
    dup = rng.random() < 0.25
    for a, b in zip(bounds[:-1], bounds[1:]):
        ln = min(int(b - a), int(rng.integers(1, 17)))
        if rng.random() < 0.3:
            continue                      # leave a hole
        targets = [int(rng.integers(0, P_RANKS))]
        if dup and rng.random() < 0.2:
            targets.append(int(rng.integers(0, P_RANKS)))
        for p in set(targets):
            if len(per_rank[p]) >= 6 or budget[p] + ln > DATA_CAP - 8:
                continue
            per_rank[p].append((int(a), ln))
            budget[p] += ln
    for p in range(P_RANKS):
        _fill_sorted(O, L, C, D, p, per_rank[p])
    return O, L, C, D


def overflow_pattern():
    """One rank pushes two identical 32-element requests into one
    32-element window: 64 elements for a round bucket of 32."""
    O = np.full((P_RANKS, REQ_CAP), 2**31 - 1, np.int32)
    L = np.zeros((P_RANKS, REQ_CAP), np.int32)
    C = np.zeros(P_RANKS, np.int32)
    D = np.zeros((P_RANKS, DATA_CAP), np.int32)
    O[0, 0] = O[0, 1] = 0
    L[0, 0] = L[0, 1] = 32
    C[0] = 2
    D[0, :64] = np.tile(np.arange(32) % 97 + 1, 2)
    return O, L, C, D


def _byte_requests(O, L, C, D):
    """The same pattern in the host executor's units: byte offsets and
    the int32 payloads' little-endian bytes."""
    reqs = []
    for p in range(P_RANKS):
        n = int(C[p])
        o = O[p, :n].astype(np.int64) * 4
        ln = L[p, :n].astype(np.int64) * 4
        total = int(L[p, :n].sum())
        payload = D[p, :total].astype("<i4").view(np.uint8).copy()
        reqs.append((o, ln, payload))
    return reqs


def _np(t) -> np.ndarray:
    return t.cpu().numpy()


def _no_drops(s) -> bool:
    return int(s["dropped_requests"]) == 0 and int(s["dropped_elems"]) == 0


def _payloads_ok(got, L, D) -> bool:
    """Every rank's read payload equals what it wrote."""
    got = _np(got)
    return all(np.array_equal(got[p][:L[p].sum()], D[p][:L[p].sum()])
               for p in range(P_RANKS))


def _builders(device):
    """``fn(method, direction="write", **knobs)``: the rank-axis writer or
    reader of ``base`` with ``knobs`` on ``device`` (TAM writes with
    ``use_kernels=True``), and ``fn.layout``."""
    from repro_torch.core import IOConfig, RankMesh, contiguous_layout
    from repro_torch.core.tam import make_tam_read, make_tam_write
    from repro_torch.core.twophase import (make_twophase_read,
                                           make_twophase_write)
    mesh = RankMesh(2, 2, 2)
    layout = contiguous_layout(FILE_LEN, 2)
    base = IOConfig(req_cap=32, data_cap=DATA_CAP, coalesce_cap=32)
    make = {("twophase", "write"): make_twophase_write,
            ("tam", "write"): lambda *a, **k: make_tam_write(
                *a, use_kernels=True, **k),
            ("twophase", "read"): make_twophase_read,
            ("tam", "read"): make_tam_read}

    def fn(method, direction="write", **knobs):
        return make[method, direction](mesh, layout, replace(base, **knobs),
                                       device=device)
    fn.layout = layout
    return fn


def _ring(cb, k, **knobs) -> dict:
    """The knobs of a depth-k ring at cb (pipelined from k = 2)."""
    return dict(cb_buffer_size=cb, pipeline=k > 1, pipeline_depth=k, **knobs)


def _handcrafted(check, fn, pname, O, L, C, D, ref) -> None:
    """The reference's checks of one handcrafted pattern."""
    file2 = ref.reshape(2, -1)
    singles = {}
    for mname in ("twophase", "tam"):
        f, _ = fn(mname)(O, L, C, D)
        singles[mname] = _np(f).reshape(-1)
        check(f"{pname}/{mname}/single_shot_vs_ref",
              np.array_equal(singles[mname], ref))
    for cb in CBS:
        n_rounds = 160 // cb
        for mname in ("twophase", "tam"):
            f, s = fn(mname, cb_buffer_size=cb)(O, L, C, D)
            got = _np(f).reshape(-1)
            tag = f"{pname}/{mname}/rounds{n_rounds}"
            check(f"{tag}_vs_ref", np.array_equal(got, ref))
            check(f"{tag}_vs_single_shot",
                  np.array_equal(got, singles[mname]))
            check(f"{tag}_no_drops", _no_drops(s))
            fp, sp = fn(mname, cb_buffer_size=cb, pipeline=True)(O, L, C, D)
            gotp = _np(fp).reshape(-1)
            check(f"{tag}_pipelined_vs_serial", np.array_equal(gotp, got))
            check(f"{tag}_pipelined_vs_ref", np.array_equal(gotp, ref))
            check(f"{tag}_pipelined_no_drops", _no_drops(sp))
        for mname in ("twophase", "tam"):
            got = fn(mname, "read", cb_buffer_size=cb)(O, L, C, file2)
            check(f"{pname}/{mname}/read_rounds{n_rounds}",
                  _payloads_ok(got, L, D))
    for mname in ("twophase", "tam"):
        got = fn(mname, "read", cb_buffer_size=32, pipeline=True)(
            O, L, C, file2)
        check(f"{pname}/{mname}/read_pipelined_rounds5",
              _payloads_ok(got, L, D))
    if pname not in ("mixed", "spanning"):
        return
    # the depth-k ring: two-phase at every round count (the 1-round row
    # exercises the depth clamp), TAM at the 5-round cb, depth-k reads
    deep = [("twophase", cb, k) for cb in CBS for k in DEPTHS] + \
        [("tam", 32, k) for k in DEPTHS]
    for mname, cb, k in deep:
        f, s = fn(mname, **_ring(cb, k))(O, L, C, D)
        tag = f"{pname}/{mname}/depth{k}_rounds{160 // cb}"
        check(f"{tag}_vs_ref", np.array_equal(_np(f).reshape(-1), ref))
        check(f"{tag}_no_drops", _no_drops(s))
    for k in DEPTHS:
        got = fn("twophase", "read", **_ring(32, k))(O, L, C, file2)
        check(f"{pname}/twophase/read_depth{k}_rounds5",
              _payloads_ok(got, L, D))
    # the slow-hop codec: rle at depths {1, 2, 4} x every round count
    # for two-phase, TAM at the 5-round cb, and one rle read
    coded = [("twophase", cb, k) for cb in CBS for k in CODEC_DEPTHS] + \
        [("tam", 32, k) for k in CODEC_DEPTHS]
    for mname, cb, k in coded:
        f, s = fn(mname, **_ring(cb, k, slow_hop_codec="rle"))(O, L, C, D)
        tag = f"{pname}/{mname}/rle_depth{k}_rounds{160 // cb}"
        check(f"{tag}_vs_ref", np.array_equal(_np(f).reshape(-1), ref))
        check(f"{tag}_no_drops", _no_drops(s))
    got = fn("twophase", "read", **_ring(32, 2, slow_hop_codec="rle"))(
        O, L, C, file2)
    check(f"{pname}/twophase/read_rle_rounds5", _payloads_ok(got, L, D))
    # the swapped placement: writes and a read at the 5-round cb
    for mname in ("twophase", "tam"):
        f, s = fn(mname, cb_buffer_size=32, placement=SWAP)(O, L, C, D)
        check(f"{pname}/{mname}/placement_swap_rounds5_vs_ref",
              np.array_equal(_np(f).reshape(-1), ref))
        check(f"{pname}/{mname}/placement_swap_no_drops", _no_drops(s))
    got = fn("twophase", "read", cb_buffer_size=32, placement=SWAP)(
        O, L, C, file2)
    check(f"{pname}/twophase/read_placement_swap_rounds5",
          _payloads_ok(got, L, D))
    # fused against unfused reads (the zero-skip decode in the ring)
    for codec in (None, "rle"):
        for k in (1, 2):
            outs = {fused: _np(fn("twophase", "read", **_ring(
                32, k, slow_hop_codec=codec, placement=SWAP,
                kernel_fusion="fused_round" if fused else None))(
                    O, L, C, file2)) for fused in (False, True)}
            tag = f"{pname}/twophase/read_{codec or 'raw'}_k{k}"
            check(f"{tag}_fused_vs_unfused",
                  np.array_equal(outs[True], outs[False]))
            check(f"{tag}_fused_vs_payload", all(
                np.array_equal(outs[True][p][:L[p].sum()],
                               D[p][:L[p].sum()]) for p in range(P_RANKS)))


# the fuzz's rank-axis writers: (method, swapped, codec, depth); two-phase
# full cross, TAM corners
FUZZ_WRITERS = [("twophase", pl, codec, k) for pl in (False, True)
                for codec in (None, "rle") for k in (1, 2)] + \
    [("tam", True, None, 1), ("tam", True, "rle", 2)]


def _fuzz(check, fn, seed, device, tmp) -> None:
    """One seeded random pattern through every executor."""
    from repro_torch.checkpoint.host_io import HostCollectiveIO
    from repro_torch.core import IOConfig
    from repro_torch.core.twophase import write_reference

    O, L, C, D = random_pattern(np.random.default_rng(7000 + seed))
    ref = write_reference(fn.layout, O, L, C, D)
    for mname, swapped, codec, k in FUZZ_WRITERS:
        knobs = _ring(32, k, slow_hop_codec=codec,
                      placement=SWAP if swapped else None)
        f, s = fn(mname, **knobs)(O, L, C, D)
        got = _np(f).reshape(-1)
        tag = f"fuzz{seed}/{mname}/pl{int(swapped)}_{codec or 'raw'}_k{k}"
        check(f"{tag}_vs_ref", np.array_equal(got, ref))
        check(f"{tag}_no_drops", _no_drops(s))
        ff, sf = fn(mname, **knobs, kernel_fusion="fused_round")(O, L, C, D)
        gotf = _np(ff).reshape(-1)
        check(f"{tag}_fused_vs_unfused", np.array_equal(gotf, got))
        check(f"{tag}_fused_vs_ref", np.array_equal(gotf, ref))
        check(f"{tag}_fused_no_drops", _no_drops(sf))
    # the host executor moves the same pattern in byte units
    breqs = _byte_requests(O, L, C, D)
    ref_bytes = ref.astype("<i4").view(np.uint8)
    hio = HostCollectiveIO(n_ranks=P_RANKS, n_nodes=2, stripe_size=640,
                           stripe_count=2, device=device)

    def file_of(path):
        return _np(hio.read_file(path, FILE_LEN * 4))
    for pi, pl in enumerate((None, "spread", SWAP)):
        ptag = ("off", "spread", "swap")[pi]
        for codec in (None, "rle"):
            for k in (1, 2):
                path = f"{tmp}/{ptag}_{codec or 'raw'}_{k}"
                hio.write(breqs, path, method="twophase", cb_bytes=128,
                          pipeline_depth=k, slow_hop_codec=codec,
                          placement=pl)
                check(f"fuzz{seed}/host/{ptag}_{codec or 'raw'}_k{k}"
                      "_vs_spmd", np.array_equal(file_of(path), ref_bytes))
    path = f"{tmp}/tam"
    hio.write(breqs, path, method="tam", local_aggregators=2, cb_bytes=128,
              pipeline_depth=2, slow_hop_codec="rle", placement=SWAP)
    check(f"fuzz{seed}/host/tam_swap_rle_k2_vs_spmd",
          np.array_equal(file_of(path), ref_bytes))
    # the unified config with the fusion selected: the host executor
    # takes it and its bytes still equal the oracle's
    cfg_host = IOConfig(req_cap=32, data_cap=DATA_CAP, coalesce_cap=32,
                        cb_buffer_size=128, pipeline=True, pipeline_depth=2,
                        slow_hop_codec="rle", placement="spread",
                        kernel_fusion="fused_round")
    path = f"{tmp}/fusedcfg"
    hio.write(breqs, path, method="twophase", config=cfg_host)
    check(f"fuzz{seed}/host/config_fused_vs_spmd",
          np.array_equal(file_of(path), ref_bytes))
    # planned reads back through the same striping, node cache on and
    # off: payloads equal the oracle's spans, the cache never models
    # slower, both modes deliver the same count
    rreqs = [(o, ln) for o, ln, _ in breqs]
    exp = [(np.concatenate([ref_bytes[o:o + n] for o, n in zip(oo, ll)])
            if oo.size else np.zeros(0, np.uint8)) for oo, ll in rreqs]

    def read_ok(outs):
        return all(np.array_equal(_np(a), b) for a, b in zip(outs, exp))
    for ptag, pl in (("off", None), ("spread", "spread")):
        for codec in (None, "rle"):
            for k in (1, 2):
                src = f"{tmp}/{ptag}_{codec or 'raw'}_{k}"
                tr = {}
                for nc in (True, False):
                    outs, tr[nc] = hio.read(
                        rreqs, src, cb_bytes=128, pipeline_depth=k,
                        slow_hop_codec=codec, placement=pl, node_cache=nc)
                    check(f"fuzz{seed}/host_read/{ptag}_{codec or 'raw'}"
                          f"_k{k}_cache{int(nc)}_vs_oracle", read_ok(outs))
                tag = f"fuzz{seed}/host_read/{ptag}_{codec or 'raw'}_k{k}"
                check(f"{tag}_cache_not_slower",
                      tr[True].total <= tr[False].total + 1e-12)
                check(f"{tag}_delivery_conserved",
                      tr[True].cache_hits + tr[True].cache_misses
                      == tr[False].cache_misses)
    if seed != 0:
        return
    # the mp executor's worker processes: one seed (each run forks a
    # fleet), placement x codec x depth, a TAM write and both reads
    for ptag, pl in (("off", None), ("swap", SWAP)):
        for codec in (None, "rle"):
            for k in (1, 2):
                path = f"{tmp}/mp_{ptag}_{codec or 'raw'}_{k}"
                hio.write(breqs, path, method="twophase", cb_bytes=128,
                          pipeline_depth=k, slow_hop_codec=codec,
                          placement=pl, transport="mp")
                check(f"fuzz{seed}/mp/{ptag}_{codec or 'raw'}_k{k}"
                      "_vs_oracle", np.array_equal(file_of(path), ref_bytes))
    path = f"{tmp}/mp_tam"
    hio.write(breqs, path, method="tam", local_aggregators=2, cb_bytes=128,
              pipeline_depth=2, slow_hop_codec="rle", placement=SWAP,
              transport="mp")
    check(f"fuzz{seed}/mp/tam_swap_rle_k2_vs_oracle",
          np.array_equal(file_of(path), ref_bytes))
    for nc in (True, False):
        outs, _ = hio.read(rreqs, f"{tmp}/mp_off_rle_2", cb_bytes=128,
                           pipeline_depth=2, slow_hop_codec="rle",
                           node_cache=nc, transport="mp")
        check(f"fuzz{seed}/mp_read/rle_k2_cache{int(nc)}_vs_oracle",
              read_ok(outs))


def run(device=None, out=None) -> Checks:
    """Every check on ``device`` (the card unless ``"cpu"``)."""
    import torch

    from repro_torch._device import resolve_device
    from repro_torch.core.twophase import write_reference

    dev = resolve_device(device)
    check = Checks(out)
    fn = _builders(dev)
    rng = np.random.default_rng(0)
    patterns = {"mixed": mixed_pattern(rng),
                "strided": strided_pattern(rng),
                "overlapping": overlapping_pattern(rng),
                "spanning": spanning_pattern(rng)}
    with torch.no_grad():
        for pname, (O, L, C, D) in patterns.items():
            _handcrafted(check, fn, pname, O, L, C, D,
                         write_reference(fn.layout, O, L, C, D))
        for seed in range(4):
            with tempfile.TemporaryDirectory() as tmp:
                _fuzz(check, fn, seed, dev, tmp)
        _, s = fn("twophase", cb_buffer_size=32)(*overflow_pattern())
        check("overflow/dropped_elems_reported", int(s["dropped_elems"]) > 0)
    return check


if __name__ == "__main__":
    sys.exit(cli(run, "The port's round-engine checks."))
