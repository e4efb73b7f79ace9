"""The port's vlm and enc-dec (audio) LMs against the reference's, on the
CPU.

Configs: reduced llava-next-34b (vlm: 2 layers, 4 image prefix rows
before the tokens) and reduced whisper-tiny (enc-dec: 2 encoder and 2
decoder layers, 8 frames, a cross-attention sub-layer in every decoder
layer). Weights: the reference's ``init_params(PRNGKey(0), cfg,
float32)``, carried by ``weights.params_from_numpy``; tokens, the
prefix embeddings (at the token embeddings' scale, 0.02 sqrt(d)) and the
frames (unit normal: frames that are all equal, as the reference CLI's,
would hide a wrong mask or key range) from numpy with a seed. Every case
holds the port (``device="cpu"``) to ``repro.models.transformer`` at
rtol = atol = 2e-3, as ``tests/test_torch_families.py`` does: the
``forward`` logits, the prefill's logits, caches and encoder output,
three teacher-forced decode steps, ``serve.generate``'s tokens (equal),
``loss_fn`` with every gradient leaf against ``jax.grad``, remat and
``init_decode_state``. The mixed-type case runs whisper with bf16
weights and f32 frames on both sides, the reference CLI's types.
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
# bf16 weights: both sides round every product and the residual stream
# to bf16 (8 bits of mantissa) in their own orders. Each side lies about
# 0.8% (relative L2) and 0.03 (largest element) from the same weights run
# in f32 on reduced whisper's unit-scale logits; the two sides may
# differ by both: every element within 2^-4 (8 bf16 ulps at 1) and a
# relative L2 distance of at most 2e-2
BF16_ATOL, BF16_REL_L2 = 2 ** -4, 2e-2
B, S = 2, 16
ARCHS = ["llava_next_34b", "whisper_tiny"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _extras(cfg, rng):
    """The non-token inputs of a batch: a vlm's prefix embeddings at the
    token embeddings' scale, an enc-dec's frames (unit normal)."""
    if cfg.frontend == "vision":
        return {"prefix_embeds": (rng.normal(
            0, 0.02 * np.sqrt(cfg.d_model),
            (B, cfg.num_prefix_embeds, cfg.d_model))).astype(np.float32)}
    return {"frames": rng.normal(0, 1, (B, cfg.enc_seq,
                                        cfg.d_model)).astype(np.float32)}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, reference config, port config, reference params, port
    params, tokens [B, S] int32, labels [B, S] int32, extras: the
    prefix embeddings or frames as numpy)."""
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
    return (arch, cfg_j, cfg_t, params_j, params_t, tokens, labels,
            _extras(cfg_t, rng))


def _batches(tokens, extras, **more):
    """The same batch for both sides: jnp arrays and torch tensors."""
    b = {"tokens": tokens, **extras, **more}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _prefix_len(cfg):
    return cfg.num_prefix_embeds if cfg.frontend == "vision" else 0


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL, **kw)


def _bf16_close(got, want):
    """``BF16_ATOL`` per element (relative to magnitudes above 1) and
    ``BF16_REL_L2`` overall."""
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    assert (np.abs(g - w) <= BF16_ATOL * np.maximum(1, np.abs(w))).all(), \
        float(np.abs(g - w).max())
    assert np.linalg.norm(g - w) <= BF16_REL_L2 * np.linalg.norm(w)


def _close_states(st_t, st_j, close=_close):
    """Both states' KV caches and encoder outputs: the same shapes and
    types and equal values (the KV caches through ``close``; the encoder
    output, f32 in every case here, at ``TOL``)."""
    assert len(st_t.kv) == len(st_j.kv)
    for (kt, vt), (kj, vj) in zip(st_t.kv, st_j.kv):
        for a, b in ((kt, kj), (vt, vj)):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            close(a, b)
    assert (st_t.enc_out is None) == (st_j.enc_out is None)
    if st_t.enc_out is not None:
        assert tuple(st_t.enc_out.shape) == st_j.enc_out.shape
        assert str(st_t.enc_out.dtype).split(".")[-1] == str(
            st_j.enc_out.dtype)
        _close(st_t.enc_out, st_j.enc_out)


def test_forward_logits(model):
    arch, cfg_j, cfg_t, params_j, params_t, tokens, _, extras = model
    bj, bt = _batches(tokens, extras)
    want, _ = JT.forward(params_j, cfg_j, bj)
    got, aux = TT.forward(params_t, cfg_t, bt)
    assert got.shape == want.shape == (B, _prefix_len(cfg_t) + S,
                                       cfg_t.padded_vocab)
    assert float(aux) == 0.0
    _close(got, want)


def test_prefill_logits_caches_and_encoder_output(model):
    arch, cfg_j, cfg_t, params_j, params_t, tokens, _, extras = model
    bj, bt = _batches(tokens, extras)
    want, st_j = JT.prefill(params_j, cfg_j, bj)
    got, st_t = TT.prefill(params_t, cfg_t, bt)
    _close(got, want)
    assert st_t.pos == int(st_j.pos) == _prefix_len(cfg_t) + S
    assert (st_t.enc_out is not None) == cfg_t.enc_dec
    _close_states(st_t, st_j)


def test_teacher_forced_decode(model):
    """Prefill the prefix (or the frames) and half the tokens, grow the
    caches, then three decode steps fed the true next tokens: both
    sides' logits, caches and encoder outputs agree at every step, and
    the logits equal the forward's at the same positions (a vlm's
    shifted by its prefix)."""
    arch, cfg_j, cfg_t, params_j, params_t, tokens, _, extras = model
    t_pre, npfx = S // 2, _prefix_len(cfg_t)
    bj, bt = _batches(tokens[:, :t_pre], extras)
    _, st_j = JT.prefill(params_j, cfg_j, bj)
    _, st_t = TT.prefill(params_t, cfg_t, bt)
    st_j = j_serve._grow_caches(st_j, S - t_pre)
    st_t = t_serve._grow_caches(st_t, S - t_pre)
    full, _ = JT.forward(params_j, cfg_j, _batches(tokens, extras)[0])
    dec = jax.jit(lambda p, s, t: JT.decode_step(p, cfg_j, s, t))
    for t in range(t_pre, t_pre + 3):
        want, st_j = dec(params_j, st_j, jnp.asarray(tokens[:, t]))
        got, st_t = TT.decode_step(params_t, cfg_t, st_t,
                                   torch.from_numpy(tokens[:, t]))
        _close(got, want)
        _close(got, np.asarray(full)[:, npfx + t])
        assert st_t.pos == int(st_j.pos) == npfx + t + 1
    _close_states(st_t, st_j)


def test_generate_tokens(model):
    """``generate`` as the reference CLI serves: tokens alone for the
    vlm, the CLI's constant frames for the enc-dec."""
    arch, cfg_j, cfg_t, params_j, params_t, tokens, _, _ = model
    prompts = tokens[:, :6]
    want = j_serve.generate(params_j, cfg_j, jnp.asarray(prompts), 5,
                            unsharded())
    got = t_serve.generate(params_t, cfg_t, torch.from_numpy(prompts), 5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_batch_is_the_reference_clis():
    """``generate`` prefills an enc-dec on ``ones * 0.01`` f32 frames of
    ``[B, enc_seq, d_model]`` on the prompts' device, and a vlm on its
    tokens alone (``request_batch``)."""
    prompts = torch.zeros((3, 4), dtype=torch.int32)
    cfg = t_reduced(t_configs.get("whisper_tiny"))
    batch = t_serve.request_batch(cfg, prompts)
    assert sorted(batch) == ["frames", "tokens"]
    assert batch["tokens"] is prompts
    frames = batch["frames"]
    assert frames.dtype == torch.float32 and frames.device.type == "cpu"
    assert torch.equal(frames, torch.full((3, cfg.enc_seq, cfg.d_model),
                                          0.01))
    cfg = t_reduced(t_configs.get("llava_next_34b"))
    assert list(t_serve.request_batch(cfg, prompts)) == ["tokens"]


def _grads(loss, live):
    return [torch.zeros_like(p) if g is None else g for p, g in zip(
        live, torch.autograd.grad(loss, live, allow_unused=True))]


def test_loss_and_every_gradient_leaf_match_the_reference(model):
    """The loss (a vlm's without its prefix rows) at 2e-3, and every
    gradient leaf (the encoder's, the cross-attention's and ``lnx``
    included) at rtol = atol = 2e-3 of the leaf's scale, as
    ``tests/test_torch_families.py`` holds them."""
    arch, cfg_j, cfg_t, params_j, _, tokens, labels, extras = model
    bj, bt = _batches(tokens, extras, labels=labels)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, cfg_j, b)))(params_j, bj)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    live = [p.requires_grad_(True) for p in leaves(params_t)]
    loss_t = TT.loss_fn(params_t, cfg_t, bt)
    grads_t = _grads(loss_t, live)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), **TOL)
    flat, _ = jax.tree_util.tree_flatten_with_path(grads_j)
    paths = [p for p, _ in leaves_with_paths(params_t)]
    assert paths == [jax.tree_util.keystr(kp) for kp, _ in flat]
    if cfg_t.enc_dec:
        for part in ("['enc_blocks']", "['enc_norm']", "['xattn']['lnx']",
                     "['xattn']['xattn']['wq']"):
            assert any(p.startswith(part) for p in paths), part
    for (kp, w), g in zip(flat, grads_t):
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        assert float(np.abs(w).max()) > 0, jax.tree_util.keystr(kp)
        _close(g / scale, w / scale, err_msg=jax.tree_util.keystr(kp))


def test_remat_gives_the_same_loss_and_gradients(model):
    arch, cfg_j, cfg_t, params_j, _, tokens, labels, extras = model
    _, batch = _batches(tokens, extras, labels=labels)
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


def test_init_decode_state_matches_the_reference(model):
    arch, cfg_j, cfg_t, *_ = model
    enc = np.ones((2, 3, cfg_t.d_model), np.float32)
    for enc_out in (None, enc):
        want = JT.init_decode_state(
            cfg_j, batch_size=2, max_seq=12,
            enc_out=None if enc_out is None else jnp.asarray(enc_out))
        got = TT.init_decode_state(
            cfg_t, batch_size=2, max_seq=12, device="cpu",
            enc_out=None if enc_out is None else torch.from_numpy(enc_out))
        _close_states(got, want)
        assert got.pos == int(want.pos) == 0


def test_whisper_bf16_weights_with_f32_frames():
    """The reference CLI's types: bf16 weights, f32 frames. JAX promotes
    the encoder to f32 (``enc_out`` f32) while the decoder stream stays
    bf16 (its KV caches and logits), and the cross-attention takes bf16
    queries against f32 keys; the port does the same. The f32 encoder
    output at ``TOL``; the bf16 logits and KV caches within
    ``BF16_ATOL`` and ``BF16_REL_L2`` (both sides round to bf16 in their
    own orders), at the forward, the prefill and a decode step."""
    cfg_j = j_reduced(j_configs.get("whisper_tiny"))
    cfg_t = t_reduced(t_configs.get("whisper_tiny"))
    params_j = JT.init_params(jax.random.PRNGKey(0), cfg_j,
                              dtype=jnp.bfloat16)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg_j.vocab, size=(B, S)).astype(np.int32)
    bj, bt = _batches(tokens[:, :S // 2], _extras(cfg_t, rng))
    assert bt["frames"].dtype == torch.float32
    want, st_j = JT.prefill(params_j, cfg_j, bj)
    got, st_t = TT.prefill(params_t, cfg_t, bt)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    assert st_t.enc_out.dtype == torch.float32
    assert str(st_j.enc_out.dtype) == "float32"
    _bf16_close(got, want)
    _close_states(st_t, st_j, _bf16_close)
    fwd_j, _ = JT.forward(params_j, cfg_j, bj)
    fwd_t, _ = TT.forward(params_t, cfg_t, bt)
    assert fwd_t.dtype == torch.bfloat16 and str(fwd_j.dtype) == "bfloat16"
    _bf16_close(fwd_t, fwd_j)
    st_j = j_serve._grow_caches(st_j, 1)
    st_t = t_serve._grow_caches(st_t, 1)
    want, _ = JT.decode_step(params_j, cfg_j, st_j,
                             jnp.asarray(tokens[:, S // 2]))
    got, st_t = TT.decode_step(params_t, cfg_t, st_t,
                               torch.from_numpy(tokens[:, S // 2]))
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    assert st_t.enc_out.dtype == torch.float32
    _bf16_close(got, want)
