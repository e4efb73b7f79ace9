"""The port's attention against the reference's, on the CPU.

The oracle is the reference's ``models.layers.flash_attention`` (the jnp
chunked attention its model runs), not its Pallas kernel, which fails on
this tree's JAX (``pl.load`` is gone). The shapes are those of
``tests/test_flash_kernel.py`` plus a decode step (``q_offset`` and
``kv_len`` into a longer cache). On the CPU the port's
``flash_attention_fused`` and ``ops.fused_attention`` run the plain
version, ``kernels.ref.flash_attention_ref``; ``test_torch_cuda.py``
holds the Hopper kernel to that on the card. Inputs come from numpy with
a seed. Tolerances are ``test_flash_kernel.py``'s: 5e-3 for f32, 5e-2
for bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models.layers import flash_attention as j_attention  # noqa: E402

from repro_torch.kernels import flash as t_flash  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402

F32 = dict(rtol=5e-3, atol=5e-3)
BF16 = dict(rtol=5e-2, atol=5e-2)


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


def _want(q, k, v, dtype=jnp.float32, **kw):
    out = j_attention(*(jnp.asarray(x, dtype) for x in (q, k, v)), **kw)
    return np.asarray(out, np.float32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


def _close(got, want, tol=F32):
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


SHAPES = [
    (1, 256, 512, 4, 4, 64),     # MHA
    (2, 256, 512, 8, 2, 64),     # GQA g=4
    (1, 512, 512, 7, 1, 32),     # odd head count (yi-like g=7)
    (1, 256, 1024, 8, 8, 128),   # hd=128
]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_and_fused_match_oracle(shape):
    b, sq, skv, hq, hkv, hd = shape
    q, k, v = mk(*shape)
    kw = dict(causal=True, window=None, logit_cap=None, q_offset=skv - sq)
    want = _want(q, k, v, **kw)
    _close(t_ref.flash_attention_ref(_t(q), _t(k), _t(v), **kw), want)
    _close(t_flash.flash_attention_fused(_t(q), _t(k), _t(v), causal=True,
                                         q_offset=skv - sq, block_q=256,
                                         block_kv=256), want)


def test_window_and_softcap():
    q, k, v = mk(2, 256, 512, 4, 2, 64)
    kw = dict(causal=True, window=64, logit_cap=30.0, q_offset=256)
    want = _want(q, k, v, **kw)
    _close(t_ref.flash_attention_ref(_t(q), _t(k), _t(v), **kw), want)
    _close(t_flash.flash_attention_fused(_t(q), _t(k), _t(v), block_q=128,
                                         block_kv=128, **kw), want)


def test_noncausal():
    q, k, v = mk(1, 256, 256, 4, 4, 64)
    kw = dict(causal=False, window=None, logit_cap=None, q_offset=0)
    want = _want(q, k, v, **kw)
    _close(t_flash.flash_attention_fused(_t(q), _t(k), _t(v), causal=False,
                                         block_q=128, block_kv=128), want)


def test_bf16():
    q, k, v = mk(1, 256, 256, 4, 2, 64)
    kw = dict(causal=True, window=None, logit_cap=None, q_offset=0)
    want = _want(q, k, v, jnp.bfloat16, **kw)
    bf = torch.bfloat16
    got = t_flash.flash_attention_fused(_t(q, bf), _t(k, bf), _t(v, bf),
                                        causal=True, block_q=128,
                                        block_kv=128)
    assert got.dtype == bf
    _close(got, want, BF16)


def test_block_divisibility_guard():
    q, k, v = mk(1, 200, 256, 4, 2, 64)
    with pytest.raises(ValueError):
        t_flash.flash_attention_fused(_t(q), _t(k), _t(v), causal=True,
                                      block_q=256, block_kv=256)


@pytest.mark.parametrize("causal,off", [(True, 100), (False, 0)])
def test_ops_fused_attention_padded_shapes(causal, off):
    """Odd Sq/Skv, which the reference's wrapper pads to blocks and the
    port's takes as they are."""
    q, k, v = mk(1, 200, 300, 4, 2, 64)
    kw = dict(causal=causal, window=None, logit_cap=None, q_offset=off)
    got = t_ops.fused_attention(_t(q), _t(k), _t(v), causal=causal,
                                q_offset=off)
    assert tuple(got.shape) == q.shape
    _close(got, _want(q, k, v, **kw))


@pytest.mark.parametrize("kv_len", [None, 150, 400])
def test_ragged_entry_takes_any_shape(kv_len):
    """``flash_attention_ragged`` is ``flash_attention_fused`` without
    the block condition: odd Sq/Skv, keys bounded by kv_len (one past
    Skv means Skv)."""
    q, k, v = mk(2, 77, 201, 6, 2, 48, seed=5)
    kw = dict(causal=True, window=40, logit_cap=30.0, q_offset=124)
    want = _want(q, k, v, kv_len=kv_len, **kw)
    _close(t_flash.flash_attention_ragged(_t(q), _t(k), _t(v),
                                          kv_len=kv_len, **kw), want)
    with pytest.raises(ValueError):
        t_flash.flash_attention_fused(_t(q), _t(k), _t(v), kv_len=kv_len,
                                      **kw)


@pytest.mark.parametrize("window,cap", [(None, None), (8, 50.0)])
def test_decode_step_into_a_longer_cache(window, cap):
    """One query per sequence at position 25 of a 40-long cache:
    ``q_offset`` = 25, ``kv_len`` = 26 (the keys past it are stale)."""
    q, k, v = mk(2, 1, 40, 4, 2, 64, seed=3)
    kw = dict(causal=False, window=window, logit_cap=cap, q_offset=25,
              kv_len=26)
    want = _want(q, k, v, **kw)
    _close(t_ops.fused_attention(_t(q), _t(k), _t(v), **kw), want)
    _close(t_layers.flash_attention(_t(q), _t(k), _t(v), **kw), want)
    # bounded by kv_len: what lies past it does not matter
    k2, v2 = k.copy(), v.copy()
    k2[:, 26:], v2[:, 26:] = 9.0, -9.0
    _close(t_ops.fused_attention(_t(q), _t(k2), _t(v2), **kw), want)


def test_prefill_longer_than_the_window():
    """Causal prefill of 300 tokens with a window of 100 and a softcap,
    the gemma2 local layer's masks, GQA g=2 at hd 16."""
    q, k, v = mk(1, 300, 300, 4, 2, 16, seed=4)
    kw = dict(causal=True, window=100, logit_cap=50.0, q_offset=0)
    want = _want(q, k, v, **kw)
    _close(t_ops.fused_attention(_t(q), _t(k), _t(v), **kw), want)
    _close(t_layers.flash_attention(_t(q), _t(k), _t(v), **kw), want)
