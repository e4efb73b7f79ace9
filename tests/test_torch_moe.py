"""The port's top-k MoE layer against the reference's, on the CPU.

``models.layers._moe_dense`` (the single-device sort-based dispatch with
capacity dropping) on the same f32 weights (the reference's
``init_moe``, carried by ``weights.params_from_numpy``) and the same
seeded numpy tokens, held to ``repro.models.layers._moe_dense`` at
rtol = atol = 2e-3 (the repo's model tolerance,
``tests/test_torch_models.py``). The routing is held exactly: the
experts each token picks equal ``lax.top_k``'s (ties to the lower
index), and the (token, k) entries the port drops equal those a plain
numpy pass over the reference's choices drops (the first ``cap`` entries
of each expert in flattened (token, k) order are kept).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.config import MoEConfig as JMoE  # noqa: E402
from repro.models.config import reduced as j_reduced  # noqa: E402
from repro.models.sharding import unsharded  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.config import MoEConfig as TMoE  # noqa: E402
from repro_torch.models.config import reduced as t_reduced  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-3)
B, S = 2, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(experts, top_k, capacity_factor):
    """Reduced kimi-k2 (d 64) with the MoE's shape overridden, in both
    packages."""
    kw = dict(num_experts=experts, top_k=top_k, d_ff_expert=32,
              capacity_factor=capacity_factor)
    return (j_reduced(j_configs.get("kimi_k2"), moe=JMoE(**kw)),
            t_reduced(t_configs.get("kimi_k2"), moe=TMoE(**kw)))


def _case(experts, top_k, capacity_factor, zero_router=False, seed=0):
    cfg_j, cfg_t = _configs(experts, top_k, capacity_factor)
    p_j = JL.init_moe(jax.random.PRNGKey(seed), cfg_j, dtype=jnp.float32)
    if zero_router:
        p_j = dict(p_j, router=jnp.zeros_like(p_j["router"]))
    p_t = params_from_numpy(jax.tree.map(np.asarray, p_j), device="cpu")
    x = np.random.default_rng(seed + 1).normal(
        size=(B, S, cfg_j.d_model)).astype(np.float32)
    return cfg_j, cfg_t, p_j, p_t, x


def _reference_choices(p_j, x, k):
    """The reference's top-k experts per token (``lax.top_k`` of the
    router's softmax, as ``_moe_dense`` computes them)."""
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ p_j["router"], axis=-1)
    return np.asarray(lax.top_k(probs, k)[1])


def _plain_drops(eids, experts, cap):
    """[N, k] bool: the entries past their expert's first ``cap`` in
    flattened (token, k) order."""
    seen = np.zeros(experts, np.int64)
    out = np.zeros(eids.size, bool)
    for i, e in enumerate(eids.reshape(-1)):
        out[i] = seen[e] >= cap
        seen[e] += 1
    return out.reshape(eids.shape)


def _check(cfg_j, cfg_t, p_j, p_t, x):
    want, aux_j = JL._moe_dense(p_j, jnp.asarray(x), cfg_j, unsharded())
    got, aux_t = TL.moe(p_t, torch.from_numpy(x), cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL)
    k, e = cfg_t.moe.top_k, cfg_t.moe.num_experts
    route = TL.moe_route(p_t, torch.from_numpy(x).reshape(-1, x.shape[-1]),
                         cfg_t)
    eids_j = _reference_choices(p_j, x, k)
    np.testing.assert_array_equal(route.eids.numpy(), eids_j)
    drops = _plain_drops(eids_j, e, route.cap)
    np.testing.assert_array_equal(route.dropped().numpy(), drops)
    return route, drops


def test_capacity_follows_the_reference_formula():
    _, cfg = _configs(16, 2, 0.5)
    for n in (1, 4, 48, 1000, 8192):
        cap = int(math.ceil(n * 2 / 16 * 0.5))
        assert TL.moe_capacity(n, cfg) == max(8, -(-cap // 8) * 8)


@pytest.mark.parametrize("top_k", [1, 2, 8])
def test_moe_dense_drops_the_reference_entries(top_k):
    """A capacity factor small enough to drop: the output, the aux loss
    and the dropped entries equal the reference's."""
    cfg_j, cfg_t, p_j, p_t, x = _case(16, top_k, 0.5, seed=top_k)
    route, drops = _check(cfg_j, cfg_t, p_j, p_t, x)
    assert 0 < drops.sum() < drops.size
    assert int(route.dropped().sum()) == int(drops.sum())


@pytest.mark.parametrize("top_k", [1, 8])
def test_moe_dense_without_drops(top_k):
    cfg_j, cfg_t, p_j, p_t, x = _case(16, top_k, 16.0, seed=10 + top_k)
    _, drops = _check(cfg_j, cfg_t, p_j, p_t, x)
    assert drops.sum() == 0


@pytest.mark.parametrize("top_k", [1, 2, 8])
def test_zero_router_ties_pick_the_lowest_experts(top_k):
    """A router of zeros gives every expert the same probability: both
    packages pick experts 0..k-1 for every token (``lax.top_k``'s tie
    order), and the capacity then drops the later tokens."""
    cfg_j, cfg_t, p_j, p_t, x = _case(16, top_k, 1.0, zero_router=True)
    route, drops = _check(cfg_j, cfg_t, p_j, p_t, x)
    np.testing.assert_array_equal(
        route.eids.numpy(), np.tile(np.arange(top_k), (B * S, 1)))
    assert drops.sum() > 0


def test_moe_dense_gradients_match_the_reference():
    """Autograd through the dispatch (the gather, the masked slot writes,
    the combine) against ``jax.grad``, with entries dropped."""
    cfg_j, cfg_t, p_j, p_t, x = _case(16, 2, 0.5, seed=3)

    def loss_j(p, xx):
        out, aux = JL._moe_dense(p, xx, cfg_j, unsharded())
        return jnp.sum(out ** 2) + aux
    g_j = jax.grad(loss_j, argnums=(0, 1))(p_j, jnp.asarray(x))
    p_t = {k: v.requires_grad_() for k, v in p_t.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = TL.moe(p_t, xt, cfg_t)
    (out.square().sum() + aux).backward()
    for name, t in p_t.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_j[0][name]),
                                   **TOL, err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j[1]), **TOL)


def test_dropped_entries_write_no_row_of_the_dispatch():
    """Every dropped entry's slot is the spare row past ``E * cap``,
    every kept one a distinct row below it."""
    cfg_j, cfg_t, p_j, p_t, x = _case(16, 2, 0.5, seed=5)
    route = TL.moe_route(p_t, torch.from_numpy(x).reshape(-1, x.shape[-1]),
                         cfg_t)
    e_cap = cfg_t.moe.num_experts * route.cap
    kept = route.slot[route.ok]
    assert bool((route.slot[~route.ok] == e_cap).all())
    assert bool((kept < e_cap).all()) and kept.unique().numel() == kept.numel()
