"""The plain reference against the program at a tiny size on the CPU,
and its control."""
import time

import numpy as np
import pytest
import torch
from conftest import CELLS, tiny_spec

from portbench import control, harness, reference

CPU = torch.device("cpu")


SEED = 2**31 + 11


def _inputs(cell, seed=SEED):
    spec = tiny_spec(cell)
    return spec, harness.make_inputs(spec.config, seed, CPU)


@pytest.mark.parametrize("traffic", ["tam_write", "twophase_write"])
def test_reference_file_equals_the_programs_write(traffic):
    from repro_torch.core import write_reference
    spec = tiny_spec("btio.tam.write", traffic)
    O, L, C, D, file_len = harness.make_inputs(spec.config, SEED, CPU)
    want = reference.scatter_file(O, L, C, D, file_len)
    write = harness.make_collective(spec.config, spec.traffic, O, D,
                                    file_len, CPU)
    got, stats = write(O, L, C, D)
    assert reference.mismatches(got.reshape(-1), want) == 0
    assert int(stats["dropped_requests"]) == int(stats["dropped_elems"]) == 0
    # and the program's own numpy oracle agrees
    assert np.array_equal(write_reference(_layout(spec, file_len),
                                          *(x.numpy() for x in (O, L, C, D))),
                          want.numpy())


def _layout(spec, file_len):
    from repro_torch.core import contiguous_layout
    return contiguous_layout(file_len, spec.config["nodes"])


def test_reference_payloads_equal_the_programs_read():
    spec, (O, L, C, D, file_len) = _inputs("btio.read")
    image = reference.scatter_file(O, L, C, D, file_len)
    read = harness.make_collective(spec.config, spec.traffic, O, D,
                                   file_len, CPU)
    want = reference.gather_payloads(O, L, C, image, D.shape[1])
    # every rank's payload comes back, zeros past its requests' length
    length = L.long().sum(dim=1, keepdim=True)
    assert bool((length < D.shape[1]).any())     # uneven ranks
    assert torch.equal(want, torch.where(
        torch.arange(D.shape[1]) < length, D, 0.0))
    assert reference.mismatches(read(O, L, C, image), want) == 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_under_the_harness(cell):
    """The control in the program's place, through ``harness.run``: the
    harness's own check calls it not correct, by every rank's last
    request."""
    spec, (O, L, C, D, _) = _inputs(cell)
    result, checks = harness.run(spec, SEED, 0.2, False, CPU,
                                 time.perf_counter(),
                                 stand_in=control.stand_in)
    assert not result["correct"] and result["failed"] >= 1
    last = int(L.gather(1, (C.long() - 1)[:, None]).sum())
    kind = "payload" if spec.traffic["direction"] == "read" else "file"
    got = {c["name"]: c["value"] for c in checks if "mismatch" in c["name"]}
    assert got == {f"{kind}_mismatch.first": last,
                   f"{kind}_mismatch.last": last}


def test_reference_refuses_overlapping_requests():
    spec, (O, L, C, D, file_len) = _inputs("btio.tam.write")
    O = O.clone()
    O[1, 0] = O[0, 0]
    with pytest.raises(ValueError, match="overlap"):
        reference.scatter_file(O, L, C, D, file_len)


def test_mismatches_counts_a_wrong_shape_as_all_wrong():
    a = torch.zeros(8, dtype=torch.int32)
    assert reference.mismatches(a[:4], a) == 8
    assert reference.mismatches(a.to(torch.int64), a) == 8


def test_mismatches_compares_floats_bit_for_bit():
    a = torch.tensor([0.0, float("nan"), 1.5], dtype=torch.float64)
    b = torch.tensor([-0.0, float("nan"), 1.5], dtype=torch.float64)
    assert reference.mismatches(a, a.clone()) == 0   # NaN bits equal
    assert reference.mismatches(b, a) == 1           # -0.0 is not 0.0


@pytest.mark.parametrize("dtype", [torch.int32, torch.float64])
def test_the_payload_is_the_seeds(dtype):
    a = harness.payload((4, 8), dtype, 2**31 + 5, CPU)
    assert torch.equal(a, harness.payload((4, 8), dtype, 2**31 + 5, CPU))
    assert not torch.equal(a, harness.payload((4, 8), dtype, 6, CPU))
    assert bool(torch.isfinite(a.double()).all())


@pytest.mark.parametrize("ranks,grid", [(16, 18), (16, 9), (64, 20)])
def test_btio_requests_cover_the_file_once_in_offset_order(ranks, grid):
    pattern = harness.load_module(harness.HERE / "patterns" / "btio.py")
    O, L, C, data_cap, file_len = pattern.btio_pattern(ranks, grid)
    assert file_len == 5 * grid**3
    cover = np.zeros(file_len, np.int32)
    for p in range(ranks):
        o, ln = O[p, :C[p]].astype(np.int64), L[p, :C[p]].astype(np.int64)
        assert (np.diff(o) > 0).all()
        for a, n in zip(o, ln):
            cover[a:a + n] += 1
    assert (cover == 1).all()
    assert data_cap == int(L.sum(axis=1).max())


def test_btio_cells_are_npbs_diagonal():
    """Rank (row, col)'s cell c is cell ((col + c) % q, (row - c) % q,
    c): its first request starts x-block (col + c) % q's first point."""
    pattern = harness.load_module(harness.HERE / "patterns" / "btio.py")
    low, size = pattern.cell_extents(18, 4)
    assert low.tolist() == [0, 5, 10, 14] and size.tolist() == [5, 5, 4, 4]
    O, L, C, _, _ = pattern.btio_pattern(16, 18)
    row, col = 1, 2                     # rank 6; its first cell is c = 0
    x, y, z = low[col], low[row], 0
    assert O[6, 0] == 5 * (x + 18 * (y + 18 * z)) and L[6, 0] == 5 * size[col]
