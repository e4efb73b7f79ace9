"""The port's moe, ssm and hybrid LMs against the reference's, on the
CPU.

Configs: reduced kimi-k2 (moe: 4 experts of d_ff 64, top-2, every layer,
capacity factor 4 as ``reduced`` sets it, so teacher-forced decode sees
no drops), reduced mamba2-2.7b (ssm: 2 Mamba2 layers, chunk 8, no MLP)
and reduced jamba-1.5 (hybrid: one super-block of 8 layers, attention
at 0 and Mamba2 at 1..7, MoE on the odd layers and the MLP on the even
ones). Weights: the reference's ``init_params(PRNGKey(0), cfg,
float32)``, carried by ``weights.params_from_numpy``; tokens from numpy
with a seed. Every case holds the port (``device="cpu"``) to
``repro.models.transformer`` at rtol = atol = 2e-3, the tolerance
``tests/test_torch_models.py`` and ``tests/test_models.py`` use: the
``forward`` logits and aux loss, the prefill's logits and caches (KV of
the attention slots, SSM and conv states of the Mamba slots), three
teacher-forced decode steps and their caches, ``serve.generate``'s
tokens (equal), and ``loss_fn`` with every gradient leaf against
``jax.grad``. The reference's own structural cases
(``test_jamba_structure``, the SSM state's independence of the history)
run on the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import reduced as j_reduced  # noqa: E402
from repro.models.sharding import unsharded  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch._tree import leaves, leaves_with_paths  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import reduced as t_reduced  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-3)
B, S = 2, 16
ARCHS = ["jamba_15_large", "kimi_k2", "mamba2_27b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, reference config, port config, reference params, port
    params, tokens [B, S] int32, labels [B, S] int32)."""
    arch = request.param
    cfg_j = j_reduced(j_configs.get(arch))
    cfg_t = t_reduced(t_configs.get(arch))
    params_j = JT.init_params(jax.random.PRNGKey(0), cfg_j,
                              dtype=jnp.float32)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    rng = np.random.default_rng(1)
    tokens, labels = (rng.integers(0, cfg_j.vocab, size=(B, S)).astype(
        np.int32) for _ in range(2))
    return arch, cfg_j, cfg_t, params_j, params_t, tokens, labels


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL, **kw)


def _close_caches(st_t, st_j):
    """Both states' per-slot caches: the same kinds in the same slots
    (a slot holds KV or SSM state, never both) and equal tensors."""
    assert len(st_t.kv) == len(st_j.kv) == len(st_t.ssm) == len(st_j.ssm)
    for field in ("kv", "ssm"):
        for j, (ct, cj) in enumerate(zip(getattr(st_t, field),
                                         getattr(st_j, field))):
            assert (ct is None) == (cj is None), (field, j)
            if ct is None:
                continue
            for a, b in zip(ct, cj):
                assert tuple(a.shape) == b.shape, (field, j)
                assert str(a.dtype).split(".")[-1] == str(b.dtype)
                _close(a.float(), np.asarray(b, np.float32),
                       err_msg=f"{field}[{j}]")
    for kv, ssm in zip(st_t.kv, st_t.ssm):
        assert (kv is None) != (ssm is None)


def test_forward_logits_and_aux(model):
    arch, cfg_j, cfg_t, params_j, params_t, tokens, _ = model
    want, aux_j = JT.forward(params_j, cfg_j, {"tokens": jnp.asarray(tokens)})
    got, aux_t = TT.forward(params_t, cfg_t,
                            {"tokens": torch.from_numpy(tokens)})
    assert got.shape == want.shape
    _close(got, want)
    assert aux_t.dtype == torch.float32
    np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL)
    assert (float(aux_t) > 0) == (cfg_t.moe is not None)


def test_prefill_logits_and_caches(model):
    arch, cfg_j, cfg_t, params_j, params_t, tokens, _ = model
    want, st_j = JT.prefill(params_j, cfg_j, {"tokens": jnp.asarray(tokens)})
    got, st_t = TT.prefill(params_t, cfg_t,
                           {"tokens": torch.from_numpy(tokens)})
    _close(got, want)
    assert st_t.pos == int(st_j.pos) == S
    _close_caches(st_t, st_j)


def test_teacher_forced_decode(model):
    """Prefill half the tokens, grow the caches (KV only), then three
    decode steps fed the true next tokens: both sides' logits and caches
    agree at every step."""
    arch, cfg_j, cfg_t, params_j, params_t, tokens, _ = model
    t_pre = S // 2
    _, st_j = JT.prefill(params_j, cfg_j,
                         {"tokens": jnp.asarray(tokens[:, :t_pre])})
    _, st_t = TT.prefill(params_t, cfg_t,
                         {"tokens": torch.from_numpy(tokens[:, :t_pre])})
    st_j = j_serve._grow_caches(st_j, S - t_pre)
    st_t = t_serve._grow_caches(st_t, S - t_pre)
    full, _ = JT.forward(params_j, cfg_j, {"tokens": jnp.asarray(tokens)})
    dec = jax.jit(lambda p, s, t: JT.decode_step(p, cfg_j, s, t))
    for t in range(t_pre, t_pre + 3):
        want, st_j = dec(params_j, st_j, jnp.asarray(tokens[:, t]))
        got, st_t = TT.decode_step(params_t, cfg_t, st_t,
                                   torch.from_numpy(tokens[:, t]))
        _close(got, want)
        _close(got, np.asarray(full)[:, t])
        assert st_t.pos == int(st_j.pos) == t + 1
    _close_caches(st_t, st_j)


def test_generate_tokens(model):
    arch, cfg_j, cfg_t, params_j, params_t, tokens, _ = model
    prompts = tokens[:, :6]
    want = j_serve.generate(params_j, cfg_j, jnp.asarray(prompts), 5,
                            unsharded())
    got = t_serve.generate(params_t, cfg_t, torch.from_numpy(prompts), 5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _grads(loss, live):
    """Autograd's gradient of every leaf, zeros for a leaf the loss does
    not read (mamba2's ``ln2``: no MLP follows), as ``jax.grad`` gives."""
    return [torch.zeros_like(p) if g is None else g for p, g in zip(
        live, torch.autograd.grad(loss, live, allow_unused=True))]


def test_loss_and_every_gradient_leaf_match_the_reference(model):
    """The loss at 2e-3, and every gradient leaf at rtol = atol = 2e-3 of
    the leaf's scale (its largest magnitude, where that exceeds 1). The
    attention's p.v rounds p, v and dP to bf16 in both packages, and its
    dv lands one bf16 ulp apart where a sum in another order rounds to
    the neighbour (``tests/test_torch_attention_grad.py`` holds dv so);
    jamba's 7 Mamba layers above its attention layer carry gradients of
    size 5 into ``embed``, where such an ulp, in a sum that cancels to
    near zero, is 2.6e-3 of absolute error."""
    arch, cfg_j, cfg_t, params_j, _, tokens, labels = model
    batch = {"tokens": tokens, "labels": labels}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, cfg_j, b)))(
        params_j, {k: jnp.asarray(v) for k, v in batch.items()})
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    live = [p.requires_grad_(True) for p in leaves(params_t)]
    loss_t = TT.loss_fn(params_t, cfg_t,
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    grads_t = _grads(loss_t, live)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), **TOL)
    flat, _ = jax.tree_util.tree_flatten_with_path(grads_j)
    assert [p for p, _ in leaves_with_paths(params_t)] == [
        jax.tree_util.keystr(kp) for kp, _ in flat]
    for (kp, w), g in zip(flat, grads_t):
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        _close(g / scale, w / scale, err_msg=jax.tree_util.keystr(kp))


def test_remat_gives_the_same_loss_and_gradients(model):
    arch, cfg_j, cfg_t, params_j, _, tokens, labels = model
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    out = []
    for remat in (False, True):
        params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                     device="cpu")
        live = [p.requires_grad_(True) for p in leaves(params_t)]
        loss = TT.loss_fn(params_t, cfg_t, batch, remat=remat)
        out.append((loss, _grads(loss, live)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_jamba_structure():
    cfg = t_configs.get("jamba_15_large")
    assert cfg.block_period == 8
    assert cfg.is_attn_layer(0) and not cfg.is_attn_layer(1)
    assert cfg.is_moe_layer(1) and not cfg.is_moe_layer(0)
    params = TT.init_params(0, t_reduced(cfg), device="cpu")
    slots = params["blocks"]["slots"]
    assert ["attn" in s for s in slots] == [True] + [False] * 7
    assert ["moe" if "moe" in s else "mlp" for s in slots] == \
        ["mlp", "moe"] * 4


@pytest.mark.parametrize("arch", ["mamba2_27b", "jamba_15_large"])
def test_ssm_state_shapes_do_not_depend_on_the_history(arch):
    """The reference's ``test_mamba2_state_decode_long_context_invariance``
    on the port: the SSM and conv states' shapes are the same for a
    cache of 8 positions and of 8192."""
    cfg = t_reduced(t_configs.get(arch))

    def shapes(max_seq):
        st = TT.init_decode_state(cfg, batch_size=2, max_seq=max_seq,
                                  device="cpu")
        return [tuple(x.shape) for c in st.ssm if c is not None for x in c]
    assert shapes(8) == shapes(8192) and shapes(8)


def test_init_decode_state_matches_the_reference(model):
    arch, cfg_j, cfg_t, *_ = model
    want = JT.init_decode_state(cfg_j, batch_size=2, max_seq=12)
    got = TT.init_decode_state(cfg_t, batch_size=2, max_seq=12, device="cpu")
    _close_caches(got, want)
    assert got.pos == int(want.pos) == 0

