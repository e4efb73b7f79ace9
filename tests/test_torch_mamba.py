"""The port's Mamba2 (SSD) block against the reference's, on the CPU.

``models.layers._ssd_chunked`` and ``mamba_block`` on the same f32
weights (the reference's ``init_mamba``, carried by
``weights.params_from_numpy``; ``A_log``, ``D`` and ``dt_bias`` made
nonzero here so that they count) and the same seeded numpy inputs, held
to ``repro.models.layers`` at rtol = atol = 2e-3 (the repo's model
tolerance): full sequences of several chunks and of one, a prompt
shorter than ``d_conv - 1`` (the conv tail zero-padded in front), decode
steps continuing a prefill against the full sequence, and a length that
does not divide into chunks raising.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.config import reduced as j_reduced  # noqa: E402
from repro.models.sharding import unsharded  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.config import reduced as t_reduced  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-3)
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def block():
    """Reduced mamba2-2.7b (d 64, d_state 16, head dim 16, chunk 8):
    (reference config, port config, reference params, port params)."""
    cfg_j = j_reduced(j_configs.get("mamba2_27b"))
    cfg_t = t_reduced(t_configs.get("mamba2_27b"))
    p_j = JL.init_mamba(jax.random.PRNGKey(0), cfg_j, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    for name in ("A_log", "D", "dt_bias", "norm"):
        p_j[name] = p_j[name] + jnp.asarray(
            rng.normal(0, 0.3, p_j[name].shape).astype(np.float32))
    p_t = params_from_numpy(jax.tree.map(np.asarray, p_j), device="cpu")
    return cfg_j, cfg_t, p_j, p_t


def _x(cfg, s, seed=1):
    return np.random.default_rng(seed).normal(
        size=(B, s, cfg.d_model)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s,chunk", [(32, 8), (8, 8), (24, 24), (5, 5)])
def test_ssd_chunked(s, chunk):
    rng = np.random.default_rng(s + chunk)
    nh, hd, ds = 4, 16, 16
    xh = rng.normal(size=(B, s, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, s, nh)))).astype(np.float32)
    A = -np.exp(rng.normal(0, 0.5, size=nh)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, s, ds)).astype(np.float32)
              for _ in range(2))
    want_y, want_st = JL._ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bm, Cm)),
                                      chunk)
    got_y, got_st = TL._ssd_chunked(*map(torch.from_numpy, (xh, dt, A, Bm,
                                                            Cm)), chunk)
    _close(got_y, want_y)
    _close(got_st, want_st)


@pytest.mark.parametrize("s", [32, 8, 2, 1])
def test_mamba_block_full_sequence(block, s):
    """Several chunks (32), one chunk (8), and prompts shorter than
    ``d_conv - 1`` (2 and 1): output, final SSM state and conv tail."""
    cfg_j, cfg_t, p_j, p_t = block
    x = _x(cfg_j, s)
    want, (st_j, tail_j) = JL.mamba_block(p_j, jnp.asarray(x), cfg_j,
                                          unsharded())
    got, (st_t, tail_t) = TL.mamba_block(p_t, torch.from_numpy(x), cfg_t)
    _close(got, want)
    _close(st_t, st_j)
    assert tail_t.shape == tail_j.shape == (B, cfg_t.mamba.d_conv - 1,
                                            tail_j.shape[-1])
    _close(tail_t, tail_j)


@pytest.mark.parametrize("t_pre", [8, 2])
def test_mamba_decode_continues_the_sequence(block, t_pre):
    """Prefill ``t_pre`` tokens, then decode one token at a time: every
    step equals the reference's decode step and the full-sequence output
    at that position."""
    cfg_j, cfg_t, p_j, p_t = block
    s = 16
    x = _x(cfg_j, s, seed=2)
    full, _ = JL.mamba_block(p_j, jnp.asarray(x), cfg_j, unsharded())
    _, st_j = JL.mamba_block(p_j, jnp.asarray(x[:, :t_pre]), cfg_j,
                             unsharded())
    _, st_t = TL.mamba_block(p_t, torch.from_numpy(x[:, :t_pre]), cfg_t)
    for t in range(t_pre, s):
        want, st_j = JL.mamba_block(p_j, jnp.asarray(x[:, t:t + 1]), cfg_j,
                                    unsharded(), state=st_j)
        got, st_t = TL.mamba_block(p_t, torch.from_numpy(x[:, t:t + 1]),
                                   cfg_t, state=st_t)
        _close(got, want)
        _close(got, np.asarray(full)[:, t:t + 1])
    for a, b in zip(st_t, st_j):
        _close(a, b)


def test_mamba_sequence_must_divide_into_chunks(block):
    cfg_j, cfg_t, p_j, p_t = block
    x = _x(cfg_j, 12)                       # chunk 8: 12 % 8 != 0
    with pytest.raises(AssertionError, match="SSD chunks"):
        JL.mamba_block(p_j, jnp.asarray(x), cfg_j, unsharded())
    with pytest.raises(ValueError, match="SSD chunks"):
        TL.mamba_block(p_t, torch.from_numpy(x), cfg_t)


def test_mamba_block_gradients_match_the_reference(block):
    cfg_j, cfg_t, p_j, p_t = block
    x = _x(cfg_j, 16, seed=4)

    def loss_j(p, xx):
        return jnp.sum(JL.mamba_block(p, xx, cfg_j, unsharded())[0] ** 2)
    g_j = jax.grad(loss_j, argnums=(0, 1))(p_j, jnp.asarray(x))
    p_t = {k: v.clone().requires_grad_() for k, v in p_t.items()}
    xt = torch.from_numpy(x).requires_grad_()
    TL.mamba_block(p_t, xt, cfg_t)[0].square().sum().backward()
    for name, t in p_t.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_j[0][name]),
                                   **TOL, err_msg=name)
    _close(xt.grad, g_j[1])


def test_masked_decay_overflow_leaves_gradients_finite():
    """A chunk whose within-chunk decay exceeds f32's exp range: the
    masked pairs (i < j) hold exp(-inf) = 0, so the forward equals the
    reference's and the gradient stays finite (a masked exp(seg) of
    +inf would make autograd's 0 x inf a NaN)."""
    rng = np.random.default_rng(9)
    s, nh, hd, ds = 64, 2, 8, 8
    xh, Bm, Cm = (rng.normal(size=sh).astype(np.float32)
                  for sh in ((1, s, nh, hd), (1, s, ds), (1, s, ds)))
    dt = np.full((1, s, nh), 2.0, np.float32)
    A = np.full(nh, -2.0, np.float32)       # 64 x 4 = 256 > ln(f32 max)
    want, _ = JL._ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bm, Cm)), s)
    ts = [torch.from_numpy(a).requires_grad_() for a in (xh, dt, A, Bm, Cm)]
    got, _ = TL._ssd_chunked(*ts, s)
    _close(got, want)
    got.square().sum().backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in ts)
