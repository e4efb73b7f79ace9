"""The algorithm of the coalesce kernel, on the CPU.

``kernels.ref.coalesce_tiled_ref`` is the plain version of the CUDA
kernel (``csrc/coalesce_kernel.cu``): each row cut into tiles (4096
entries, one CTA of the row's cluster each), tile totals shared by every
tile of the row, the run open at a tile's start carried from the nearest
earlier tile with a boundary, and every output word written exactly once
(the model raises otherwise). It is held exactly against the port's
plain version ``coalesce_ref`` and the reference's Pallas ``coalesce``
in interpret mode, at the kernel's tile and at smaller tiles (more tiles
a row), on the card tests' cases (``test_torch_cuda._coalesce_case``).
Inputs come from numpy with a seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import coalesce_kernel as j_ck  # noqa: E402

from repro_torch.kernels import ref as t_ref  # noqa: E402

from test_torch_cuda import (PAD, _coalesce_case,  # noqa: E402
                             _long_coalesce_case)

TILE = t_ref.COALESCE_TILE
# (case, rows, n): one to eight tiles a row, ragged last tiles, runs
# across tile edges, tiles of padding only, pads inside the live part,
# the rows whose ends wrap, off[0] == -1
CASES = ([("tail", 2, k * TILE) for k in range(1, 9)]
         + [("tail", 2, n) for n in (4097, 12289, 32767)]
         + [("long_runs", 3, 12288), ("all_pad", 3, 8192),
            ("interspersed", 2, 9000), ("wrap", 3, 8), ("neg_start", 2, 4100)])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check(offs, lens, tile):
    o, ln = torch.from_numpy(offs), torch.from_numpy(lens)
    got = t_ref.coalesce_tiled_ref(o, ln, tile)
    for g, w in zip(got, t_ref.coalesce_ref(o, ln)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    want = j_ck.coalesce(jnp.asarray(offs), jnp.asarray(lens),
                         interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


@pytest.mark.parametrize("case,rows,n", CASES)
def test_tiled_model_at_the_kernels_tile(case, rows, n):
    offs, lens = _coalesce_case(np.random.default_rng(n), case, rows, n)
    assert offs.shape == (rows, n) and n <= 8 * TILE   # one cluster a row
    _check(offs, lens, TILE)


@pytest.mark.parametrize("tile", [1, 2, 3, 5, 8, 64])
@pytest.mark.parametrize("case", ["wrap", "neg_start", "interspersed",
                                  "all_pad"])
def test_tiled_model_at_smaller_tiles(case, tile):
    n = 8 if case == "wrap" else 600
    _check(*_coalesce_case(np.random.default_rng(tile), case, 2, n), tile)


def test_tiled_model_counts_and_runs():
    """A run across several tile edges comes out as one request: the
    carry of its start crossed every edge."""
    offs = (np.arange(64, dtype=np.int32) * 3)[None]
    lens = np.full((1, 64), 3, np.int32)
    offs[0, 40:], lens[0, 40:] = PAD, 0
    o, ln, c = _check(offs, lens, 8)
    assert int(c[0]) == 1 and int(o[0, 0]) == 0 and int(ln[0, 0]) == 120
    assert (o[0, 1:] == PAD).all() and (ln[0, 1:] == 0).all()


@pytest.mark.parametrize("case,rows,n", [
    ("tail", 3, 65536), ("tail", 2, 131072), ("long_runs", 2, 65536),
    ("all_pad", 3, 65536), ("interspersed", 2, 65536), ("wrap", 2, 65536),
    ("few_runs", 2, 131072), ("many_runs", 2, 131072),
    ("edges", 2, 131072), ("edges", 3, 65536)])
def test_ops_coalesce_of_rows_longer_than_one_block(case, rows, n):
    """``ops.coalesce`` takes rows longer than the kernel's 32768 (TAM
    stage 1 at 1024 requests a rank): its passes over blocks, also when
    more runs are left than one block holds, equal the plain version on
    the whole row."""
    from repro_torch.core.requests import RequestList
    from repro_torch.kernels import ops
    offs, lens = _long_coalesce_case(np.random.default_rng(n + rows), case,
                                     rows, n)
    o, ln = torch.from_numpy(offs), torch.from_numpy(lens)
    got = ops.coalesce(RequestList(o, ln, torch.zeros(rows,
                                                      dtype=torch.int32)))
    want = t_ref.coalesce_ref(o, ln)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["tail", "interspersed", "wrap",
                                  "neg_start"])
def test_ops_coalesce_refuses_long_rows_it_cannot_cut(case):
    """Rows longer than one block with padding inside their live part or
    an offset of -1 (which sorted lists do not hold) raise."""
    from repro_torch.core.requests import RequestList
    from repro_torch.kernels import ops
    offs, lens = _coalesce_case(np.random.default_rng(1), case, 2, 65536)
    with pytest.raises(ValueError, match="padding only at a row's tail"):
        ops.coalesce(RequestList(torch.from_numpy(offs),
                                 torch.from_numpy(lens),
                                 torch.zeros(2, dtype=torch.int32)))
