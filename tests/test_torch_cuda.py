"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (they need
``nvcc`` to build the kernels, and a card to run them). On a machine
with one, run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import requests as t_rq  # noqa: E402
from repro_torch.kernels import coalesce_kernel as t_ck  # noqa: E402
from repro_torch.kernels import fused_round as t_fr  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.kernels import sort as t_sort  # noqa: E402

PAD = t_rq.PAD_OFFSET


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def _coalesce_rows(rng, batch, n):
    offs = np.tile(np.arange(n, dtype=np.int32) * 4, (batch, 1))
    gaps = rng.random((batch, n)) < 0.3
    offs = offs + np.cumsum(gaps, axis=1).astype(np.int32) * 2
    lens = np.full((batch, n), 4, np.int32)
    return offs, lens


def _drain_list(rng, cap, n, base, dup=0):
    """An unsorted drain list: n disjoint requests at or after ``base``
    (the first ``dup`` repeated with identical payload), shuffled among
    PAD slots, with a payload stream covering every listed length."""
    gaps = rng.integers(1, 9, size=n)
    ln = rng.integers(1, 6, size=n).astype(np.int32)
    o = (np.cumsum(gaps) + np.concatenate([[0], np.cumsum(ln)[:-1]])
         + base).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(ln)[:-1]]).astype(np.int32)
    o, ln, starts = (np.concatenate([x, x[:dup]]) for x in (o, ln, starts))
    full = [np.full(cap, PAD, np.int32), np.zeros(cap, np.int32),
            np.zeros(cap, np.int32)]
    slots = rng.permutation(cap)[:len(o)]
    for f, x in zip(full, (o, ln, starts)):
        f[slots] = x
    data = rng.integers(1, 1 << 30, size=int(ln.sum()) + 7).astype(np.int32)
    return (*full, data)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run with `-m cuda` on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch", [(2, 1), (8, 3), (1024, 5), (8192, 64),
                                     (32768, 16)])
def test_cuda_bitonic_sort_equals_plain(cuda, n, batch):
    rng = np.random.default_rng(n)
    offs = rng.integers(0, 1000, size=(batch, n)).astype(np.int32)
    offs[:, ::3] = PAD
    args = [_t(offs).to(cuda)] + [
        _t(rng.integers(0, 1 << 30, size=(batch, n)).astype(np.int32)).to(cuda)
        for _ in range(2)]
    before = t_sort.bitonic_sort.launches
    got = t_sort.bitonic_sort(*args)
    assert t_sort.bitonic_sort.launches == before + 1
    for g, w in zip(got, t_ref.sort_ref(*args)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch", [(8, 1), (100, 3), (4096, 7),
                                     (32768, 16)])
def test_cuda_coalesce_equals_plain(cuda, n, batch):
    rng = np.random.default_rng(n)
    offs, lens = _coalesce_rows(rng, batch, n)
    offs[:, n - n // 5:], lens[:, n - n // 5:] = PAD, 0
    if n > 20:
        offs[0, 10:12], lens[0, 10:12] = PAD, 0    # interspersed padding
    o, ln = _t(offs).to(cuda), _t(lens).to(cuda)
    for g, w in zip(t_ck.coalesce(o, ln), t_ref.coalesce_ref(o, ln)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.uint8,
                                   torch.int16, torch.int64])
def test_cuda_fused_sort_pack_equals_plain(cuda, dtype):
    rng = np.random.default_rng(3)
    rows = [_drain_list(rng, 2048, 400, 8192 * (i + 1), dup=i)
            for i in range(4)]
    dcap = max(r[3].size for r in rows)
    data = np.stack([np.pad(r[3], (0, dcap - r[3].size)) for r in rows])
    args = [_t(np.stack([r[k] for r in rows])).to(cuda) for k in range(3)]
    d = _t(data % 200).to(cuda).to(dtype)
    bases = torch.tensor([8192 * (i + 1) for i in range(4)],
                         dtype=torch.int32, device=cuda)
    got = t_fr.fused_sort_pack(*args, d, bases, 8192)
    want = t_ref.fused_sort_pack_ref(*args, d, bases, 8192)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((2, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        t_sort.bitonic_sort(x, x, x.to(torch.int64))
    with pytest.raises(ValueError):
        t_ck.coalesce(x.t().contiguous().t()[:, :32], x[:, :32])


def _zero_skip_rows(rng, rows, n, dtype):
    """About half zeros, an all-zero and a no-zero row; float rows also
    hold -0.0 (a zero) and NaN (a nonzero)."""
    x = rng.integers(-5, 6, size=(rows, n)) * (rng.random((rows, n)) < 0.5)
    x = x.astype(np.float32 if dtype == torch.float32 else np.int32)
    x[0] = 0
    x[1] = np.where(x[1] == 0, 3, x[1])
    if dtype == torch.float32 and rows > 2:
        x = x * np.float32(0.75)
        x[2, ::3] = np.float32(-0.0)
        x[2, 1::7] = np.nan
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("rows,n", [(2, 1), (3, 8), (5, 100), (4, 4096),
                                    (3, 5000), (16, 262144)])
def test_cuda_zero_skip_equal_plain(cuda, dtype, rows, n):
    """Both kernels equal their plain versions bit for bit, through the
    ops wrappers that pad odd widths to a power of two."""
    from repro_torch.kernels import ops as t_ops
    x = _t(_zero_skip_rows(np.random.default_rng(n), rows, n, dtype)
           ).to(cuda)
    before = (t_fr.zero_skip_encode.launches,
              t_fr.zero_skip_decode.launches)
    vals, pos = t_ops.rle_zero_skip_encode(x)
    out = t_ops.rle_zero_skip_decode((vals, pos))
    assert (t_fr.zero_skip_encode.launches,
            t_fr.zero_skip_decode.launches) == (before[0] + 1, before[1] + 1)
    n2 = 1 << max(n - 1, 1).bit_length()
    padded = torch.nn.functional.pad(x, (0, n2 - n))
    wv, wp = t_ref.zero_skip_encode_ref(padded)
    assert torch.equal(vals.view(torch.int32), wv[:, :n].view(torch.int32))
    assert torch.equal(pos, wp[:, :n])
    want = t_ref.zero_skip_decode_ref(wv, wp)[:, :n]
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_cuda_zero_skip_decode_of_scattered_positions(cuda):
    """decode takes any order of positions, not only the encoder's."""
    rng = np.random.default_rng(9)
    n = 1024
    pos = np.stack([rng.permutation(n) for _ in range(3)]).astype(np.int32)
    pos[:, ::5] = -1
    vals = rng.integers(1, 1 << 30, size=(3, n)).astype(np.int32)
    v, p = _t(vals).to(cuda), _t(pos).to(cuda)
    assert torch.equal(t_fr.zero_skip_decode(v, p),
                       t_ref.zero_skip_decode_ref(v, p))


@pytest.mark.cuda
def test_cuda_zero_skip_rejects_other_dtypes(cuda):
    for dtype in (torch.int64, torch.float16, torch.uint8):
        x = torch.zeros((2, 64), dtype=dtype, device=cuda)
        with pytest.raises(TypeError):
            t_fr.zero_skip_encode(x)
        with pytest.raises(TypeError):
            t_fr.zero_skip_decode(x, torch.zeros((2, 64), dtype=torch.int32,
                                                 device=cuda))
    x = torch.zeros((2, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        t_fr.zero_skip_decode(x, x.to(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["twophase", "tam"])
def test_cuda_write_equals_cpu_write(cuda, method):
    """A small BTIO write: file and every stats key on the card equal
    the same write on the CPU, and the file equals write_reference."""
    from repro_torch.core import (IOConfig, RankMesh, contiguous_layout,
                                  make_tam_write, make_twophase_write,
                                  write_reference)
    from repro_torch.io_patterns.generators import btio_write_pattern
    O, L, C, D = btio_write_pattern(16, 64, 4, 8, seed=3)
    layout = contiguous_layout(4 * 64 * 64 * 8, 4)
    cfg = IOConfig(req_cap=O.shape[1], data_cap=D.shape[1],
                   coalesce_cap=64, cb_buffer_size=4096,
                   kernel_fusion="fused_round")
    mk = make_twophase_write if method == "twophase" else make_tam_write
    kw = {"use_kernels": True} if method == "tam" else {}
    f_gpu, s_gpu = mk(RankMesh(4, 1, 4), layout, cfg, device=cuda,
                      **kw)(O, L, C, D)
    f_cpu, s_cpu = mk(RankMesh(4, 1, 4), layout, cfg, device="cpu",
                      **kw)(O, L, C, D)
    assert torch.equal(f_gpu.cpu(), f_cpu)
    assert (f_cpu.numpy().reshape(-1).tobytes()
            == write_reference(layout, O, L, C, D).tobytes())
    for k in s_cpu:
        assert torch.equal(s_gpu[k].cpu(), s_cpu[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["rle", "ef-int8"])
@pytest.mark.parametrize("method", ["twophase", "tam"])
def test_cuda_codec_write_and_read_equal_cpu(cuda, method, codec):
    """A small BTIO write and read-back with a slow-hop codec: the card
    equals the CPU (file, stats and payloads; within the 5e-2 band of
    the reference's tests for the lossy float codec), and the fused rle
    path launches both zero-skip kernels."""
    from repro_torch.core import (IOConfig, RankMesh, contiguous_layout,
                                  make_tam_read, make_tam_write,
                                  make_twophase_read, make_twophase_write,
                                  write_reference)
    from repro_torch.io_patterns.generators import btio_write_pattern
    O, L, C, D = btio_write_pattern(16, 64, 4, 8, seed=4)
    D = D.copy()
    D[:, ::2] = 0
    if codec == "ef-int8":
        D = D.astype(np.float32) / np.float32(1 << 20)
    layout = contiguous_layout(4 * 64 * 64 * 8, 4)
    ref = write_reference(layout, O, L, C, D)
    cfg = IOConfig(req_cap=O.shape[1], data_cap=D.shape[1],
                   coalesce_cap=64, cb_buffer_size=4096, pipeline=True,
                   pipeline_depth=2, kernel_fusion="fused_round",
                   slow_hop_codec=codec)
    write = make_twophase_write if method == "twophase" else make_tam_write
    read = make_twophase_read if method == "twophase" else make_tam_read
    mesh = RankMesh(4, 1, 4)
    before = (t_fr.zero_skip_encode.launches,
              t_fr.zero_skip_decode.launches)
    f_gpu, s_gpu = write(mesh, layout, cfg, device=cuda)(O, L, C, D)
    p_gpu = read(mesh, layout, cfg, device=cuda)(O, L, C,
                                                 torch.as_tensor(ref))
    f_cpu, s_cpu = write(mesh, layout, cfg, device="cpu")(O, L, C, D)
    p_cpu = read(mesh, layout, cfg, device="cpu")(O, L, C,
                                                  torch.as_tensor(ref))
    for k in s_cpu:
        assert torch.equal(s_gpu[k].cpu(), s_cpu[k]), k
    if codec == "rle":
        assert torch.equal(f_gpu.cpu(), f_cpu)
        assert torch.equal(p_gpu.cpu(), p_cpu)
        assert f_cpu.numpy().reshape(-1).tobytes() == ref.tobytes()
        assert t_fr.zero_skip_encode.launches > before[0]
        assert t_fr.zero_skip_decode.launches > before[1]
    else:
        band = 5e-2 * np.abs(ref).max()
        assert np.abs(f_gpu.cpu().numpy().reshape(-1) - ref).max() < band
        assert (p_gpu.cpu() - p_cpu).abs().max().item() < band
