"""The block-sort-and-merge algorithm of the port's sort, on the CPU.

``kernels.ref.sort_blocks_merge_ref`` is the plain version of the
algorithm ``sort.bitonic_sort``'s CUDA kernels run (``csrc/bitonic.cuh``):
64-bit words of key and row position, bitonic networks over blocks,
merge passes with the kernel's merge-path cuts, carries gathered by
position. It is held exactly against ``ref.sort_ref`` for the block the
kernel picks at every n from 2 to 32768 (and smaller blocks and chunks,
so that short rows merge too), and against the reference's Pallas
``bitonic_sort`` in interpret mode. Inputs come from numpy with a seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import sort as j_sort  # noqa: E402

from repro_torch.core import requests as t_rq  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.kernels import sort as t_sort  # noqa: E402

PAD = t_rq.PAD_OFFSET
INT32_MIN = -(1 << 31)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(rng, batch, n, keys):
    """Keys drawn from ``keys`` (duplicates likely), a third PAD, with
    random lengths and carries."""
    offs = rng.choice(np.asarray(keys, dtype=np.int64), size=(batch, n))
    offs = offs.astype(np.int32)
    offs[:, ::3] = PAD
    lens = rng.integers(0, 1 << 30, size=(batch, n)).astype(np.int32)
    carry = rng.integers(-(1 << 31), 1 << 31, size=(batch, n),
                         dtype=np.int64).astype(np.int32)
    return offs, lens, carry


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


KEYS = [INT32_MIN, INT32_MIN + 1, -70000, -1, 0, 1, 5, 512, 1 << 27,
        PAD - 1, PAD]


@pytest.mark.parametrize("n", [1 << k for k in range(1, 16)])
@pytest.mark.parametrize("batch", [1, 16])
def test_model_equals_sort_ref_at_the_kernels_block(n, batch):
    rng = np.random.default_rng(n + batch)
    args = [torch.as_tensor(x) for x in _rows(rng, batch, n, KEYS)]
    _equal(t_ref.sort_blocks_merge_ref(*args, t_sort.sort_block(n)),
           t_ref.sort_ref(*args))


# (n, block, chunk, items): blocks below the kernel's, so that short rows
# take merge passes, and chunks and thread shares of several sizes
SMALL = [(2, 1, 2, 1), (8, 2, 8, 2), (64, 4, 16, 4), (256, 8, 32, 8),
         (1024, 64, 128, 8), (1024, 16, 64, 4), (4096, 256, 2048, 8),
         (8192, 1024, 2048, 8), (32768, 2048, 2048, 8),
         (32768, 4096, 512, 2)]


@pytest.mark.parametrize("n,block,chunk,items", SMALL)
def test_model_equals_sort_ref_at_smaller_blocks(n, block, chunk, items):
    rng = np.random.default_rng(block * 3 + chunk)
    args = [torch.as_tensor(x) for x in _rows(rng, 3, n, range(-40, 40))]
    _equal(t_ref.sort_blocks_merge_ref(*args, block, chunk, items),
           t_ref.sort_ref(*args))


@pytest.mark.parametrize("case", ["all_equal", "all_pad", "extremes",
                                  "descending"])
@pytest.mark.parametrize("n,block", [(4096, 4096), (8192, 4096),
                                     (32768, 4096), (512, 16)])
def test_model_on_edge_keys(case, n, block):
    rng = np.random.default_rng(n)
    batch = 2
    if case == "all_equal":     # stability: the carries keep their order
        offs = np.full((batch, n), 7, np.int32)
    elif case == "all_pad":
        offs = np.full((batch, n), PAD, np.int32)
    elif case == "extremes":
        offs = rng.choice(np.asarray([INT32_MIN, -1, 0, PAD], np.int64),
                          size=(batch, n)).astype(np.int32)
    else:
        offs = np.tile(np.arange(n, 0, -1, dtype=np.int32) - n // 2,
                       (batch, 1))
    lens = np.tile(np.arange(n, dtype=np.int32), (batch, 1))
    carry = rng.integers(0, 1 << 30, size=(batch, n)).astype(np.int32)
    args = [torch.as_tensor(x) for x in (offs, lens, carry)]
    got = t_ref.sort_blocks_merge_ref(*args, block)
    _equal(got, t_ref.sort_ref(*args))
    if case in ("all_equal", "all_pad"):
        assert torch.equal(got[1], args[1])


@pytest.mark.parametrize("n,block", [(8, 8), (256, 256), (256, 16),
                                     (2048, 2048), (2048, 64)])
def test_model_equals_the_reference_kernel(n, block):
    """Against the Pallas network (interpret mode): exactly, on unique
    keys; on duplicate keys the keys exactly and each key's (length,
    carry) pairs as a multiset (the TPU network orders ties
    arbitrarily)."""
    rng = np.random.default_rng(n + block)
    batch = 2
    unique = np.stack([rng.permutation(np.arange(-n, n, 2, dtype=np.int32))
                       for _ in range(batch)])
    dup = _rows(rng, batch, n, KEYS + list(range(-8, 8)))[0]
    lens = rng.integers(0, 1 << 30, size=(batch, n)).astype(np.int32)
    carry = rng.integers(0, 1 << 30, size=(batch, n)).astype(np.int32)
    for offs in (unique, dup):
        got = [x.numpy() for x in t_ref.sort_blocks_merge_ref(
            torch.as_tensor(offs), torch.as_tensor(lens),
            torch.as_tensor(carry), block)]
        want = [np.asarray(x) for x in j_sort.bitonic_sort(
            jnp.asarray(offs), jnp.asarray(lens), jnp.asarray(carry),
            interpret=True)]
        np.testing.assert_array_equal(got[0], want[0])
        if offs is unique:
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[2], want[2])
        for r in range(batch):
            assert sorted(zip(*(g[r] for g in got))) == \
                sorted(zip(*(w[r] for w in want)))


@pytest.mark.parametrize("n,block,passes,planes", [
    (2, 2, 0, 0), (1024, 1024, 0, 0), (4096, 4096, 0, 0),
    (8192, 4096, 1, 1), (16384, 4096, 2, 2), (32768, 4096, 3, 2)])
def test_block_and_passes_the_kernel_picks(n, block, passes, planes):
    assert t_sort.sort_block(n) == block
    assert t_sort.merge_passes(n) == passes
    assert t_sort.word_scratch(3, n, "cpu").shape == (planes, 3, n)


def test_model_rejects_a_block_that_does_not_divide_the_row():
    x = torch.zeros((1, 64), dtype=torch.int32)
    for block in (0, 3, 128):
        with pytest.raises(ValueError):
            t_ref.sort_blocks_merge_ref(x, x, x, block)
