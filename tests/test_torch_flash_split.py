"""The split-over-the-cache attention and the route choice, on the CPU.

``kernels.ref.flash_attention_split_ref`` is the plain version of the
``split_decode`` route's algorithm (per-chunk partials (m, l, acc) and
their merge). It is held against ``ref.flash_attention_ref`` and against
the reference's ``models.layers.flash_attention`` (the jnp attention its
model runs; its Pallas kernel fails on this tree's JAX) in f32 at 5e-3,
the reference's kernel tolerance, over chunk counts from 1 to more
chunks than the keys fill (chunks with no key), windows, ``kv_len`` and
``q_offset``. ``flash._route`` and ``flash._split_chunks`` are pure
functions of shapes: every decode step of gemma2-9b takes
``split_decode`` and its prefills ``tc_prefill``. Inputs come from numpy
with a seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models.layers import flash_attention as j_attention  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch import kernels as t_kernels  # noqa: E402
from repro_torch.kernels import flash as t_flash  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402

F32 = dict(rtol=5e-3, atol=5e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mk(b, sq, skv, hq, hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, sq, hq, hd), (b, skv, hkv, hd),
                           (b, skv, hkv, hd)))


# (b, sq, skv, hq, hkv, hd, causal, window, cap, q_offset, kv_len,
#  n_chunks)
SPLIT_CASES = [
    (1, 1, 300, 4, 2, 32, False, None, None, 299, 300, 1),    # one chunk
    (2, 1, 300, 4, 2, 32, False, None, 50.0, 299, 300, 3),    # softcap
    (1, 1, 700, 8, 2, 16, False, None, None, 650, 651, 11),   # kv_len
    (2, 1, 512, 4, 4, 16, False, 100, 30.0, 400, 401, 4),     # window
    (1, 1, 256, 4, 1, 16, False, None, None, 99, 100, 33),    # empty chunks
    (1, 4, 400, 4, 1, 16, True, None, None, 300, None, 5),    # causal rows
    (1, 8, 600, 4, 2, 16, True, 50, None, 500, 508, 6),       # window edges
    (1, 16, 1024, 2, 2, 16, True, 20, 30.0, 900, None, 64),   # many chunks
]


def _kw(case):
    (_, _, _, _, _, _, causal, window, cap, q_offset, kv_len, _) = case
    return dict(causal=causal, window=window, logit_cap=cap,
                q_offset=q_offset, kv_len=kv_len)


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_ref_matches_plain_and_oracle(case):
    b, sq, skv, hq, hkv, hd = case[:6]
    q, k, v = mk(b, sq, skv, hq, hkv, hd, seed=sq + skv)
    kw = _kw(case)
    got = t_ref.flash_attention_split_ref(
        *(torch.from_numpy(x) for x in (q, k, v)), n_chunks=case[-1], **kw)
    plain = t_ref.flash_attention_ref(
        *(torch.from_numpy(x) for x in (q, k, v)), **kw)
    want = np.asarray(j_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                  **kw), np.float32)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **F32)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_split_ref_bf16_matches_plain():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in mk(1, 1, 1000, 16, 8, 64, seed=7))
    kw = dict(causal=False, window=None, logit_cap=50.0, q_offset=999,
              kv_len=1000)
    got = t_ref.flash_attention_split_ref(q, k, v, n_chunks=9, **kw)
    want = t_ref.flash_attention_ref(q, k, v, **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=8e-3, atol=8e-3)


def test_split_ref_chunk_count_does_not_change_the_result():
    q, k, v = (torch.from_numpy(x) for x in mk(2, 2, 900, 8, 4, 32, seed=3))
    kw = dict(causal=True, window=300, logit_cap=None, q_offset=800,
              kv_len=None)
    outs = [t_ref.flash_attention_split_ref(q, k, v, n_chunks=n, **kw)
            for n in (1, 2, 7, 40)]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), **F32)


def test_split_ref_wrong_chunk_bounds_fail():
    """A planted fault: the keys cut one tile short of kv_len changes the
    result beyond the tolerance, so the tests above can see it."""
    q, k, v = (torch.from_numpy(x) for x in mk(1, 1, 700, 8, 2, 16, seed=5))
    kw = dict(causal=False, window=None, logit_cap=None, q_offset=650)
    good = t_ref.flash_attention_split_ref(q, k, v, n_chunks=4, kv_len=651,
                                           **kw)
    short = t_ref.flash_attention_split_ref(q, k, v, n_chunks=4,
                                            kv_len=651 - 64, **kw)
    assert float((good - short).abs().max()) > 5e-3


GEMMA = configs.get("gemma2_9b")
G_SHAPE = (GEMMA.n_heads, GEMMA.n_kv_heads, GEMMA.head_dim)


@pytest.mark.parametrize("batch,prompt", [(4, 32), (1, 8192)])
def test_serve_routes_gemma2(batch, prompt):
    """The serve phase's calls: the prefill on the tensor cores; every
    one of its 16 decode steps (query length 1 against the cache grown
    to prompt + 16; the route depends on neither the position nor the
    cache length) split over the cache into enough chunks for the
    card; f32 on the tensor-core f32 kernel."""
    hq, hkv, hd = G_SHAPE
    assert t_flash._route(batch, prompt, hq, hkv, hd,
                          torch.bfloat16) == "tc_prefill"
    assert t_flash._route(batch, 1, hq, hkv, hd,
                          torch.bfloat16) == "split_decode"
    cache = prompt + 16
    n = t_flash._split_chunks(batch, hkv, cache)
    assert batch * hkv * n >= min(t_flash.SPLIT_TARGET_CTAS,
                                  batch * hkv * -(-cache // 128))
    assert t_flash._route(batch, 1, hq, hkv, hd,
                          torch.float32) == "tc_f32"


def test_split_chunks_at_serve_shapes():
    assert t_flash._split_chunks(1, 8, 8208) == 33    # 264 CTAs
    assert t_flash._split_chunks(4, 8, 8208) == 9     # 288 CTAs
    assert t_flash._split_chunks(4, 8, 48) == 1       # short cache
    assert t_flash._split_chunks(64, 8, 8208) == 1    # big batch
    assert t_flash._split_chunks(1, 2, 32768) == 132  # glm4's 2 kv heads


@pytest.mark.parametrize("sq,g,route", [(16, 1, "split_decode"),
                                        (17, 1, "tc_prefill"),
                                        (8, 2, "split_decode"),
                                        (9, 2, "tc_prefill"),
                                        (1, 16, "split_decode"),
                                        (2, 16, "tc_prefill"),
                                        (2, 7, "split_decode"),
                                        (3, 7, "tc_prefill")])
def test_route_threshold(sq, g, route):
    """bf16 calls of at most 16 (query, head) rows per (batch, kv head)
    split over the cache: qwen1.5 (g 1), gemma2 (2), yi (7), glm4 (16)."""
    assert t_flash._route(1, sq, 2 * g, 2, 128, torch.bfloat16) == route


@pytest.mark.parametrize("args,exc", [
    ((1, 1, 2, 2, 128, torch.float16), TypeError),
    ((1, 1, 2, 2, 512, torch.bfloat16), ValueError),
    ((1, 1, 2, 2, 512, torch.float32), ValueError),
    ((1, 64, 2, 2, 0, torch.bfloat16), ValueError),
    ((2 ** 14, 64 * 65536, 2, 2, 64, torch.float32), ValueError),
])
def test_route_rejects(args, exc):
    with pytest.raises(exc):
        t_flash._route(*args)


def test_route_takes_odd_head_dims_where_the_kernels_do():
    """Every head dim in [1, 256] has a route in both types: the bf16
    tiles take rows that are not 16-byte multiples element by element."""
    assert t_flash._route(1, 64, 4, 2, 20, torch.float32) == "tc_f32"
    assert t_flash._route(1, 64, 14, 2, 80, torch.bfloat16) == "tc_prefill"
    assert t_flash._route(1, 64, 4, 2, 20, torch.bfloat16) == "tc_prefill"
    assert t_flash._route(1, 1, 4, 2, 37, torch.bfloat16) == "split_decode"
    assert t_flash._route(1, 64, 4, 2, 1, torch.bfloat16) == "tc_prefill"


def test_launches_by_route_reset_and_cpu_counts_nothing():
    t_flash.flash_attention_fused.launches_by_route["tc_prefill"] = 3
    t_kernels.reset_launch_counts()
    assert t_flash.flash_attention_fused.launches_by_route == {
        "tc_prefill": 0, "split_decode": 0, "tc_f32": 0}
    q = torch.zeros((1, 1, 4, 16), dtype=torch.bfloat16)
    k = torch.zeros((1, 64, 2, 16), dtype=torch.bfloat16)
    t_flash.flash_attention_ragged(q, k, k, causal=False, q_offset=63)
    assert t_flash.flash_attention_fused.launches == 0
    assert set(t_flash.flash_attention_fused.launches_by_route.values()) \
        == {0}
