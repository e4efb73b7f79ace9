"""The port's dense LM against the reference's, on the CPU.

Weights: the reference's ``init_params(PRNGKey(0), reduced(cfg),
dtype=float32)``, carried into the port by ``weights.params_from_numpy``.
Tokens come from numpy with a seed and go to both sides. Each case holds
the port (``device="cpu"``: attention through the plain version,
``kernels.ref.flash_attention_ref``) against ``repro.models.transformer``
at rtol = atol = 2e-3, the tolerance ``tests/test_models.py`` holds
decode to forward with.

Configs: reduced gemma2-9b with its window cut to 6 so that 16 tokens
cross it (softcaps and the local/global alternation as published),
reduced qwen1.5-32b (qkv bias, biases made nonzero here so that they
count) and reduced yi-34b with 14 query heads over 2 kv heads (g = 7,
yi's published grouping).
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
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import reduced as t_reduced  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-3)
B, S = 2, 16
OVERRIDES = {"gemma2_9b": {"window": 6},
             "qwen15_32b": {},
             "yi_34b": {"n_heads": 14, "n_kv_heads": 2}}
ARCHS = sorted(OVERRIDES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only contends with JAX's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch):
    over = OVERRIDES.get(arch, {})
    return (j_reduced(j_configs.get(arch), **over),
            t_reduced(t_configs.get(arch), **over))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, reference config, port config, reference params, port
    params, tokens [B, S] int32)."""
    arch = request.param
    cfg_j, cfg_t = _configs(arch)
    params_j = JT.init_params(jax.random.PRNGKey(0), cfg_j,
                              dtype=jnp.float32)
    if cfg_j.qkv_bias:   # the reference initialises the biases to zero
        rng = np.random.default_rng(7)
        params_j = jax.tree_util.tree_map_with_path(
            lambda path, x: (x + jnp.asarray(
                rng.normal(0, 0.1, x.shape).astype(np.float32))
                if jax.tree_util.keystr(path).endswith(("['bq']", "['bk']",
                                                        "['bv']"))
                else x), params_j)
    params_t = params_from_numpy(_np_tree(params_j), device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg_j.vocab, size=(B, S)).astype(np.int32)
    return arch, cfg_j, cfg_t, params_j, params_t, tokens


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_config_copy_equals_reference():
    for arch in j_configs.ARCHS:
        j, t = j_configs.get(arch), t_configs.get(arch)
        assert repr(j) == repr(t).replace("repro_torch.", "repro."), arch


def test_forward_logits(model):
    arch, cfg_j, cfg_t, params_j, params_t, tokens = model
    want, _ = JT.forward(params_j, cfg_j, {"tokens": jnp.asarray(tokens)})
    got, aux = TT.forward(params_t, cfg_t,
                          {"tokens": torch.from_numpy(tokens)})
    assert got.shape == want.shape and float(aux) == 0.0
    _close(got, want)


def test_prefill_logits_and_caches(model):
    arch, cfg_j, cfg_t, params_j, params_t, tokens = model
    want, st_j = JT.prefill(params_j, cfg_j, {"tokens": jnp.asarray(tokens)})
    got, st_t = TT.prefill(params_t, cfg_t,
                           {"tokens": torch.from_numpy(tokens)})
    _close(got, want)
    assert st_t.pos == int(st_j.pos) == S
    assert len(st_t.kv) == len(st_j.kv) == cfg_t.block_period
    for (kt, vt), (kj, vj) in zip(st_t.kv, st_j.kv):
        assert kt.shape == kj.shape
        _close(kt, kj)
        _close(vt, vj)


def test_teacher_forced_decode(model):
    """Prefill half the tokens, then three decode steps fed the true
    next tokens: both sides' logits agree at every step."""
    arch, cfg_j, cfg_t, params_j, params_t, tokens = model
    t_pre = S // 2
    _, st_j = JT.prefill(params_j, cfg_j,
                         {"tokens": jnp.asarray(tokens[:, :t_pre])})
    _, st_t = TT.prefill(params_t, cfg_t,
                         {"tokens": torch.from_numpy(tokens[:, :t_pre])})
    st_j = j_serve._grow_caches(st_j, S - t_pre)
    st_t = t_serve._grow_caches(st_t, S - t_pre)
    dec = jax.jit(lambda p, s, t: JT.decode_step(p, cfg_j, s, t))
    for t in range(t_pre, t_pre + 3):
        want, st_j = dec(params_j, st_j, jnp.asarray(tokens[:, t]))
        got, st_t = TT.decode_step(params_t, cfg_t, st_t,
                                   torch.from_numpy(tokens[:, t]))
        _close(got, want)
        assert st_t.pos == int(st_j.pos) == t + 1
    for (kt, vt), (kj, vj) in zip(st_t.kv, st_j.kv):
        _close(kt, kj)
        _close(vt, vj)


def test_generate_tokens(model):
    arch, cfg_j, cfg_t, params_j, params_t, tokens = model
    prompts = tokens[:, :6]
    want = j_serve.generate(params_j, cfg_j, jnp.asarray(prompts), 5,
                            unsharded())
    got = t_serve.generate(params_t, cfg_t, torch.from_numpy(prompts), 5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_params_cross_bit_for_bit():
    cfg_j, _ = _configs("gemma2_9b")
    params_j = JT.init_params(jax.random.PRNGKey(3), cfg_j,
                              dtype=jnp.bfloat16)
    params_t = params_from_numpy(_np_tree(params_j), device="cpu")
    leaves_j = jax.tree_util.tree_leaves_with_path(params_j)
    n = 0
    for path, x in leaves_j:
        node = params_t
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        want = np.asarray(x)
        if want.dtype.name == "bfloat16":
            assert node.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                node.view(torch.int16).numpy().view(np.uint16),
                want.view(np.uint16))
            n += 1
        else:
            assert node.dtype == torch.float32
            np.testing.assert_array_equal(node.numpy(), want)
    assert n > 0


@pytest.mark.parametrize("arch", ["qwen15_32b", "kimi_k2", "mamba2_27b",
                                  "jamba_15_large", "llava_next_34b",
                                  "whisper_tiny"])
def test_port_init_params_tree_matches_reference(arch):
    """The port's own ``init_params`` gives the reference's tree: the
    same paths, shapes and dtypes (the moe router in f32, Mamba's
    ``A_log``, ``D``, ``dt_bias`` and ``norm`` in f32, whisper's
    ``enc_blocks``, ``enc_norm`` and ``xattn`` stacked on its
    layers)."""
    cfg_j, cfg_t = _configs(arch)
    want = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                 cfg_j, jnp.bfloat16))
    got = TT.init_params(0, cfg_t, device="cpu")
    flat_j = {jax.tree_util.keystr(p): x
              for p, x in jax.tree_util.tree_leaves_with_path(want)}
    flat_t = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + f"[{k!r}]")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + f"[{i}]")
        else:
            flat_t[path] = node
    walk(got, "")
    assert sorted(flat_t) == sorted(flat_j)
    for k, x in flat_j.items():
        assert tuple(flat_t[k].shape) == x.shape, k
        assert str(flat_t[k].dtype).split(".")[-1] == str(x.dtype), k

