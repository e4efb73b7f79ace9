"""``REPRO_PERF_OPTS=0`` on the port against the reference, on the CPU.

The reference's ``models.layers.perf_opts_enabled`` reads the setting at
every call; off, its ``flash_attention`` takes keys 1024 at a time and
keeps p.v in f32. The port's switch (``repro_torch._perf_opts``,
exported as ``models.layers.perf_opts_enabled``) steers the plain
attention (``kernels.ref.flash_attention_ref``) and, through
``ops.fused_attention``, the kernels' f32 p.v variants. With the setting
off (``monkeypatch.setenv``):

* the port's f32 attention (plain, ``flash_attention_fused`` given
  ``pv32=True`` and ``layers.flash_attention``, all the plain version
  on the CPU) equals
  the reference's at ``test_torch_attention.py``'s shapes within max abs
  1e-4 and relative L2 1e-5; the default variant's bf16 p.v
  (``pv32=False``) misses that limit (it differs by about 2e-3);
* its gradient equals ``jax.vjp`` of the reference at
  ``test_torch_attention_grad.py``'s limits;
* reduced gemma2's forward logits equal the reference's at 2e-3, the
  distance printed beside the default setting's (``-s``);
* the arithmetic models of the kernels' variants
  (``flash_attention_tc_f32_ref``, ``flash_attention_split_ref``,
  ``flash_attention_bwd_split_ref`` with ``pv32=True``) are within the
  card check's limits of the plain version under the setting.

With the setting unset, the plain attention's ``pv32=None`` resolves to
the default variant and equals its ``pv32=False`` output bit for bit.
About 40 s.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import reduced as j_reduced  # noqa: E402
from repro.models.layers import flash_attention as j_attention  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.kernels import flash as t_flash  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import reduced as t_reduced  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402

MAX_ABS, REL_L2 = 1e-4, 1e-5
GRAD_TOL = {"q": dict(rtol=1e-4, atol=1e-4), "k": dict(rtol=1e-4, atol=1e-4),
            "v": dict(rtol=8e-3, atol=1e-4)}   # test_torch_attention_grad's
MODEL_TOL = 2e-3
# (b, sq, skv, hq, hkv, hd): test_torch_attention.py's shapes
SHAPES = [(1, 256, 512, 4, 4, 64), (2, 256, 512, 8, 2, 64),
          (1, 512, 512, 7, 1, 32), (1, 256, 1024, 8, 8, 128)]
# (b, sq, skv, hq, hkv, hd, causal, window, cap, q_offset, kv_len):
# test_torch_attention_grad.py's cases, a row of 4200 keys included
GRAD_CASES = [
    (1, 24, 24, 4, 4, 16, True, None, None, 0, None),
    (2, 24, 24, 8, 2, 16, True, None, None, 0, None),
    (1, 32, 32, 4, 2, 32, True, 7, 50.0, 0, None),
    (1, 16, 40, 6, 2, 16, True, None, 30.0, 24, None),
    (2, 4, 48, 4, 1, 16, False, None, 50.0, 30, 31),
    (1, 20, 20, 7, 1, 24, False, None, None, 0, None),
    (1, 4, 4200, 4, 2, 16, True, 4100, 50.0, 4196, None),
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def perf_opts_off(monkeypatch):
    monkeypatch.setenv("REPRO_PERF_OPTS", "0")
    assert not t_layers.perf_opts_enabled()


def _inputs(shape, seed=0, scale=1.0):
    b, sq, skv, hq, hkv, hd = shape
    rng = np.random.default_rng(seed)
    return tuple((scale * rng.standard_normal(s)).astype(np.float32)
                 for s in ((b, sq, hq, hd), (b, skv, hkv, hd),
                           (b, skv, hkv, hd)))


def _distance(got, want):
    g = got.detach().float().numpy()
    return (float(np.abs(g - want).max()),
            float(np.linalg.norm(g - want) / np.linalg.norm(want)))


def _attention_kw(case):
    causal, window, cap, q_offset, kv_len = case[6:]
    return dict(causal=causal, window=window, logit_cap=cap,
                q_offset=q_offset, kv_len=kv_len)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("window,cap", [(None, None), (64, 30.0)],
                         ids=["causal", "window_cap"])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_f32_attention_matches_the_reference_with_the_setting_off(
        perf_opts_off, shape, window, cap):
    q, k, v = _inputs(shape)
    kw = dict(causal=True, window=window, logit_cap=cap,
              q_offset=shape[2] - shape[1])
    want = np.asarray(j_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                  **kw))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for name, got in (
            ("plain", t_ref.flash_attention_ref(tq, tk, tv, **kw)),
            ("fused", t_flash.flash_attention_fused(
                tq, tk, tv, block_q=1, block_kv=1, pv32=True, **kw)),
            ("layers", t_layers.flash_attention(tq, tk, tv, **kw))):
        max_abs, rel = _distance(got, want)
        assert max_abs <= MAX_ABS and rel <= REL_L2, (name, max_abs, rel)
    # the default variant's bf16 p.v is a planted fault here
    max_abs, rel = _distance(
        t_ref.flash_attention_ref(tq, tk, tv, pv32=False, **kw), want)
    assert max_abs > MAX_ABS and rel > REL_L2, (max_abs, rel)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("case", GRAD_CASES, ids=range(len(GRAD_CASES)))
def test_gradient_matches_the_reference_autodiff_with_the_setting_off(
        perf_opts_off, case):
    rng = np.random.default_rng(0)
    b, sq, skv, hq, hkv, hd = case[:6]
    q = (2 * rng.standard_normal((b, sq, hq, hd))).astype(np.float32)
    k = (2 * rng.standard_normal((b, skv, hkv, hd))).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, hd)).astype(np.float32)
    dout = rng.standard_normal((b, sq, hq, hd)).astype(np.float32)
    kw = _attention_kw(case)
    _, vjp = jax.vjp(lambda a, b_, c: j_attention(a, b_, c, **kw),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = t_ops.fused_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL[name],
                                   err_msg=name)


def _gemma2():
    over = {"window": 6}
    cfg_j = j_reduced(j_configs.get("gemma2_9b"), **over)
    cfg_t = t_reduced(t_configs.get("gemma2_9b"), **over)
    params_j = JT.init_params(jax.random.PRNGKey(0), cfg_j,
                              dtype=jnp.float32)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg_j.vocab, size=(2, 16)).astype(np.int32)
    return cfg_j, cfg_t, params_j, params_t, tokens


@pytest.mark.timeout(120)
def test_gemma2_forward_matches_the_reference_in_both_settings(monkeypatch):
    cfg_j, cfg_t, params_j, params_t, tokens = _gemma2()
    seen = {}
    for setting in ("1", "0"):
        monkeypatch.setenv("REPRO_PERF_OPTS", setting)
        want, _ = JT.forward(params_j, cfg_j, {"tokens": jnp.asarray(tokens)})
        got, _ = TT.forward(params_t, cfg_t,
                            {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=MODEL_TOL, atol=MODEL_TOL)
        seen[setting] = (got, _distance(got, np.asarray(want)))
    print("gemma2 forward vs reference (max abs, rel L2): setting on "
          f"{seen['1'][1]}, off {seen['0'][1]}")
    # the setting reached the attention: the two outputs differ
    assert not torch.equal(seen["1"][0], seen["0"][0])


def test_default_setting_is_the_bf16_pv_variant(monkeypatch):
    monkeypatch.delenv("REPRO_PERF_OPTS", raising=False)
    assert t_layers.perf_opts_enabled()
    q, k, v = (torch.from_numpy(x) for x in _inputs(SHAPES[1], seed=2))
    kw = dict(causal=True, window=None, logit_cap=None, q_offset=256)
    default = t_ref.flash_attention_ref(q, k, v, **kw)
    assert torch.equal(default, t_ref.flash_attention_ref(q, k, v,
                                                          pv32=False, **kw))
    assert torch.equal(default, t_ops.fused_attention(q, k, v, **kw))
    assert not torch.equal(default, t_ref.flash_attention_ref(
        q, k, v, pv32=True, **kw))
    monkeypatch.setenv("REPRO_PERF_OPTS", "1")
    assert torch.equal(default, t_ref.flash_attention_ref(q, k, v, **kw))


@pytest.mark.parametrize("value,enabled", [("1", True), ("0", False),
                                           ("false", False), ("", False)])
def test_the_switch_reads_the_environment_at_every_call(monkeypatch, value,
                                                        enabled):
    monkeypatch.setenv("REPRO_PERF_OPTS", value)
    assert t_layers.perf_opts_enabled() is enabled
    from repro.models.layers import perf_opts_enabled as j_enabled
    assert j_enabled() is enabled


# ---- the arithmetic models of the kernels' f32 p.v variants -------------

@pytest.mark.timeout(120)
@pytest.mark.parametrize("shape,cap", [((1, 96, 200, 4, 2, 64), 50.0),
                                       ((2, 70, 70, 6, 3, 37), None)])
def test_tc_f32_model_of_the_pv32_variant(perf_opts_off, shape, cap):
    """``tc_f32``'s f32 p.v model (p and v split into TF32 halves) is
    within relative L2 1e-5 of the plain version with the setting off;
    the default model's bf16 p.v is not."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(shape, scale=1.5))
    kw = dict(causal=True, window=None, logit_cap=cap, q_offset=0)
    want = t_ref.flash_attention_ref(q, k, v, **kw).numpy()
    assert _distance(t_ref.flash_attention_tc_f32_ref(q, k, v, pv32=True,
                                                      **kw), want)[1] <= REL_L2
    assert _distance(t_ref.flash_attention_tc_f32_ref(q, k, v, pv32=False,
                                                      **kw), want)[1] > REL_L2


@pytest.mark.timeout(120)
@pytest.mark.parametrize("n_chunks", [1, 3])
def test_split_decode_model_of_the_pv32_variant(perf_opts_off, n_chunks):
    """``split_decode``'s f32 p.v model (bf16(p) + bf16(p - bf16(p))
    against bf16 values) on bf16 inputs: within 2e-5 of the plain
    version's f32 arithmetic on the same bf16 values, where the
    default's bf16 p is 100 times farther."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs((2, 1, 900, 8, 2, 64), seed=4))
    kw = dict(causal=False, window=None, logit_cap=30.0, q_offset=850,
              kv_len=851)
    want = t_ref.flash_attention_ref(*(x.float() for x in (q, k, v)), **kw)
    got = t_ref.flash_attention_split_ref(q.float(), k.float(), v.float(),
                                          n_chunks=n_chunks, pv32=True, **kw)
    default = t_ref.flash_attention_split_ref(
        q.float(), k.float(), v.float(), n_chunks=n_chunks, pv32=False, **kw)
    rel = _distance(got, want.numpy())[1]
    assert rel <= 2e-5 and _distance(default, want.numpy())[1] > 100 * rel


@pytest.mark.timeout(120)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_model_of_the_pv32_variant(perf_opts_off, dtype):
    """The backward kernel's f32 p.v model against the plain backward
    with the setting off, at the card check's limits (relative L2 1e-4
    in f32, 1e-2 in bf16); in f32 the default model misses them. In
    bf16, against the f32 p.v gradient of the same values in f32, at
    least 0.99 of dv's elements equal it rounded to bf16 and fewer of
    the default model's, and dq and dk are nearer than the default's."""
    case = (1, 48, 48, 4, 2, 32, True, 20, 50.0, 0, None)
    rng = np.random.default_rng(6)
    b, sq, skv, hq, hkv, hd = case[:6]
    q, k = (torch.from_numpy((2 * rng.standard_normal(s)).astype(np.float32))
            .to(dtype) for s in ((b, sq, hq, hd), (b, skv, hkv, hd)))
    v = torch.from_numpy(rng.standard_normal((b, skv, hkv, hd))
                         .astype(np.float32)).to(dtype)
    dout = torch.from_numpy(rng.standard_normal((b, sq, hq, hd))
                            .astype(np.float32)).to(dtype)
    kw = _attention_kw(case)
    out = t_ref.flash_attention_ref(q, k, v, **kw)
    want = t_ref.flash_attention_bwd_ref(q, k, v, out, dout, **kw)
    limit = 1e-4 if dtype == torch.float32 else 1e-2
    got = t_ref.flash_attention_bwd_split_ref(q, k, v, out, dout, pv32=True,
                                              **kw)
    for g, w in zip(got, want):
        assert _distance(g, w.float().numpy())[1] <= limit
    default = t_ref.flash_attention_bwd_split_ref(q, k, v, out, dout,
                                                  pv32=False, **kw)
    if dtype == torch.float32:
        assert max(_distance(g, w.numpy())[1]
                   for g, w in zip(default, want)) > limit
        return
    # bf16: both models against the f32 p.v gradient of the same values
    # in f32, rounded to bf16; dv's elements bit-equal to it (the default
    # rounds p~ for dv), dq and dk nearer than the default's (both carry
    # D from the bf16 output)
    want32 = t_ref.flash_attention_bwd_ref(
        *(x.float() for x in (q, k, v, out, dout)), pv32=True, **kw)
    seen = {}
    for name, g, d, w in zip(("dq", "dk", "dv"), got, default, want32):
        wb = w.to(torch.bfloat16).view(torch.int16)
        seen[name] = tuple(
            f(x) for x in (g.to(torch.bfloat16), d.to(torch.bfloat16))
            for f in (lambda t: float((t.view(torch.int16) == wb)
                                      .float().mean()),
                      lambda t: _distance(t, w.numpy())[1]))
    assert seen["dv"][0] >= 0.99 > seen["dv"][2], seen
    for name in ("dq", "dk"):
        share, rel, share_default, rel_default = seen[name]
        assert share > share_default and rel < rel_default, (name, seen)
