"""The gradient of the port's attention against the reference's, on the
CPU.

The reference trains through XLA's autodiff of its model's attention
(``repro.models.layers.flash_attention``, the jnp chunked attention: it
has no Pallas backward). The port's plain attention,
``kernels.ref.flash_attention_ref``, follows it line for line, so its
autograd gradient (``ref.flash_attention_bwd_ref``, the yardstick of the
CUDA backward kernel) is held against ``jax.vjp`` of the reference on
the same numpy inputs and the same cotangent: causal, window, softcap,
``q_offset``, ``kv_len``, GQA and a row longer than one 4096-key chunk,
in f32. dq and dk are held at rtol = atol = 1e-4 (both round p, v, dP
and dv to bf16 where the model does; what is left is the order of f32
sums); dv, rounded to bf16 once a key, at rtol 8e-3 (one bf16 ulp: a
sum in another order may round to the neighbour) and atol 1e-4.

``ops.fused_attention`` and ``layers.flash_attention`` go through the
autograd function ``flash.FlashAttention`` when an input requires grad;
on the CPU its backward is the plain one, checked here too.

The CUDA backward takes dP, dk and dq on the tensor cores as split
TF32 products and, for f32 inputs, the logits and dv as FMA chains that
give the plain version's bits; ``ref.flash_attention_bwd_split_ref``
models that arithmetic on the CPU. It is held to the plain backward
under the card check's f32 limits (``F32_LIMITS``: chip_smoke's
``BWD_TOL``) and to the reference's autodiff at 2e-3; a single TF32
product in place of each product is shown to fail the f32 limits (the
split is what passes them), and so, at head dim 256, are logits taken
as split TF32 products or exactly (the FMA chains are what pass them
there).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.layers import flash_attention as j_attention  # noqa: E402

from repro_torch.kernels import flash as t_flash  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402

TOL = {"q": dict(rtol=1e-4, atol=1e-4), "k": dict(rtol=1e-4, atol=1e-4),
       "v": dict(rtol=8e-3, atol=1e-4)}

# (b, sq, skv, hq, hkv, hd, causal, window, cap, q_offset, kv_len)
CASES = [
    (1, 24, 24, 4, 4, 16, True, None, None, 0, None),      # MHA, causal
    (2, 24, 24, 8, 2, 16, True, None, None, 0, None),      # GQA g=4
    (1, 32, 32, 4, 2, 32, True, 7, 50.0, 0, None),         # window + cap
    (1, 16, 40, 6, 2, 16, True, None, 30.0, 24, None),     # q_offset
    (2, 4, 48, 4, 1, 16, False, None, 50.0, 30, 31),       # decode, kv_len
    (1, 20, 20, 7, 1, 24, False, None, None, 0, None),     # g=7, non-causal
    (1, 4, 4200, 4, 2, 16, True, 4100, 50.0, 4196, None),  # two chunks
]
IDS = ["mha", "gqa", "window_cap", "q_offset", "decode_kv_len", "g7",
       "two_chunks"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, seed=0):
    b, sq, skv, hq, hkv, hd = case[:6]
    rng = np.random.default_rng(seed)
    # logits of a few units, so the softcap bends them
    q = (2 * rng.standard_normal((b, sq, hq, hd))).astype(np.float32)
    k = (2 * rng.standard_normal((b, skv, hkv, hd))).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, hd)).astype(np.float32)
    dout = rng.standard_normal((b, sq, hq, hd)).astype(np.float32)
    causal, window, cap, q_offset, kv_len = case[6:]
    kw = dict(causal=causal, window=window, logit_cap=cap,
              q_offset=q_offset, kv_len=kv_len)
    return q, k, v, dout, kw


def _reference_grads(q, k, v, dout, kw):
    _, vjp = jax.vjp(lambda a, b, c: j_attention(a, b, c, **kw),
                     *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_the_reference_autodiff(case):
    q, k, v, dout, kw = _inputs(case)
    want = _reference_grads(q, k, v, dout, kw)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = t_ref.flash_attention_ref(tq, tk, tv, **kw)
    got = t_ref.flash_attention_bwd_ref(tq, tk, tv, out,
                                        torch.from_numpy(dout), **kw)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, **TOL[name], err_msg=name)


@pytest.mark.parametrize("case", CASES[:4], ids=IDS[:4])
def test_fused_attention_records_the_plain_backward_on_the_cpu(case):
    """Where an input requires grad, ``ops.fused_attention`` returns an
    output of ``FlashAttention`` whose backward (on the CPU the plain
    one) gives ``flash_attention_bwd_ref``'s gradient; ``layers``' CPU
    attention is autograd of the plain version, the same numbers."""
    q, k, v, dout, kw = _inputs(case, seed=1)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = t_ops.fused_attention(*leaves, **kw)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    want = t_ref.flash_attention_bwd_ref(*(x.detach() for x in leaves),
                                         out.detach(),
                                         torch.from_numpy(dout), **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    cpu = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out2 = t_layers.flash_attention(*cpu, **kw)
    for g, w in zip(torch.autograd.grad(out2, cpu, torch.from_numpy(dout)),
                    want):
        assert torch.equal(g, w)


def test_no_grad_calls_skip_the_autograd_function():
    """Serving (no input requires grad) keeps the forward-only call."""
    q, k, v, _, kw = _inputs(CASES[1])
    out = t_ops.fused_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                **kw)
    assert out.grad_fn is None
    before = t_flash.flash_attention_bwd.launches
    t_flash.flash_attention_bwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                out, out, **kw)
    assert t_flash.flash_attention_bwd.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_types_and_shapes(dtype):
    q, k, v, dout, kw = _inputs(CASES[2])
    tq, tk, tv, td = (torch.from_numpy(x).to(dtype) for x in (q, k, v, dout))
    out = t_ref.flash_attention_ref(tq, tk, tv, **kw)
    dq, dk, dv = t_flash.flash_attention_bwd(tq, tk, tv, out, td, **kw)
    assert (dq.dtype, dk.dtype, dv.dtype) == (dtype,) * 3
    assert dq.shape == tq.shape and dk.shape == tk.shape \
        and dv.shape == tv.shape
    # dv is a sum of bf16(p) . dO' rounded to bf16 once a key
    assert torch.equal(dv.float(), dv.float().to(torch.bfloat16).float())
    with pytest.raises(ValueError, match="mismatch"):
        t_flash.flash_attention_bwd(tq, tk, tv, out[:, :1], td, **kw)


def test_bwd_scratch_keeps_the_logits_within_its_byte_budget():
    """The backward kernel's scratch: dO' in q's layout, four words a
    row, and q . k of every row against the keys rounded up to the
    stats pass's tile, or None (each pass recomputes it) past
    ``BWD_DOTS_MAX_BYTES``."""
    from unittest import mock
    q = torch.zeros(2, 5, 4, 16)
    dos, stats, dots = t_flash.bwd_scratch(q, 70)
    assert dos.shape == q.shape and dos.dtype == torch.float32
    assert stats.shape == (2, 5, 4, 4)
    n = 2 * 4 * 5 * 2 * t_flash.BWD_DOTS_KEYS
    assert dots.dtype == torch.float32 and dots.numel() == n
    with mock.patch.object(t_flash, "BWD_DOTS_MAX_BYTES", 4 * n):
        assert t_flash.bwd_scratch(q, 70)[2].numel() == n
    with mock.patch.object(t_flash, "BWD_DOTS_MAX_BYTES", 4 * n - 1):
        assert t_flash.bwd_scratch(q, 70)[2] is None


# ------------------------------------------------- the split TF32 products

# chip_smoke.BWD_TOL: every element within rtol |want| + atol max|want|,
# and a relative L2 distance
F32_LIMITS = {"rtol": 1.6e-2, "atol": 2e-3, "rel_l2": 1e-4}
BF16_LIMITS = {"rtol": 1.6e-2, "atol": 1e-2, "rel_l2": 1e-2}


def _within(got, want, limits):
    """``(every element within, relative L2)`` of one gradient."""
    g, w = got.float(), want.float()
    scale = float(w.abs().max())
    elem = bool(((g - w).abs() <= limits["rtol"] * w.abs()
                 + limits["atol"] * scale).all())
    rel = float((g - w).norm() / w.norm().clamp(min=1e-30))
    return elem and rel <= limits["rel_l2"], rel


def _split_and_plain(case, dtype=torch.float32, **split_kw):
    q, k, v, dout, kw = _inputs(case)
    tq, tk, tv, td = (torch.from_numpy(x).to(dtype) for x in (q, k, v, dout))
    out = t_ref.flash_attention_ref(tq, tk, tv, **kw)
    plain = t_ref.flash_attention_bwd_ref(tq, tk, tv, out, td, **kw)
    split = t_ref.flash_attention_bwd_split_ref(tq, tk, tv, out, td, **kw,
                                                **split_kw)
    return split, plain


def test_tf32_split_rounds_to_nearest_away_and_keeps_bf16_exact():
    """hi keeps 10 mantissa bits, halfway cases rounded away from zero
    (``cvt.rna``); lo is what is left, rounded the same way; a bf16
    value splits into itself and 0."""
    half = 2.0 ** -11   # half a TF32 ulp at 1
    x = torch.tensor([1 + half, -(1 + half), 1 + half / 2, 3.0,
                      1 + half + 2.0 ** -20], dtype=torch.float32)
    hi, lo = t_ref.tf32_split(x)
    assert hi.tolist() == [1 + 2 * half, -(1 + 2 * half), 1.0, 3.0,
                           1 + 2 * half]
    assert torch.equal(lo, t_ref.tf32_split(x - hi)[0])
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    b = torch.randn(1000, generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16).float()
    bh, bl = t_ref.tf32_split(b)
    assert torch.equal(bh, b) and bl.eq(0).all()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_backward_holds_the_f32_limits_of_the_plain_backward(case):
    split, plain = _split_and_plain(case)
    for name, g, w in zip(("dq", "dk", "dv"), split, plain):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        ok, rel = _within(g, w, F32_LIMITS)
        assert ok, (name, rel)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_backward_matches_the_reference_autodiff(case):
    q, k, v, dout, kw = _inputs(case)
    want = _reference_grads(q, k, v, dout, kw)
    tq, tk, tv, td = (torch.from_numpy(x) for x in (q, k, v, dout))
    out = t_ref.flash_attention_ref(tq, tk, tv, **kw)
    got = t_ref.flash_attention_bwd_split_ref(tq, tk, tv, out, td, **kw)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-3, atol=2e-3,
                                   err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_a_single_tf32_product_fails_the_f32_limits(case):
    """The same algorithm with each tensor-core product, the logits
    too, one TF32 product (10 mantissa bits) lands 1e-3 to 4e-3 from the
    plain backward, over the f32 relative L2 limit of 1e-4 in every
    gradient: the split's second and third terms are what hold it."""
    one, plain = _split_and_plain(case, terms=1, logits="tf32")
    for name, g, w in zip(("dq", "dk", "dv"), one, plain):
        ok, rel = _within(g, w, F32_LIMITS)
        assert not ok and rel > 10 * F32_LIMITS["rel_l2"], (name, rel)


@pytest.mark.parametrize("case", CASES[:3], ids=IDS[:3])
def test_split_backward_of_bf16_inputs(case):
    """bf16 inputs (q and k exact in TF32, one product for the logits):
    bf16 gradients within the card check's bf16 limits."""
    split, plain = _split_and_plain(case, dtype=torch.bfloat16)
    for name, g, w in zip(("dq", "dk", "dv"), split, plain):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        ok, rel = _within(g, w, BF16_LIMITS)
        assert ok, (name, rel)


# q [2, 256, 4, 256], k and v [2, 256, 2, 256], causal, softcap 50: the
# training path's head dim, where a logit is a sum of 256 products
WIDE = (2, 256, 256, 4, 2, 256, True, None, 50.0, 0, None)


def test_split_logits_miss_the_f32_limits_at_head_dim_256():
    """Logits as split TF32 products (about 1e-6 relative, as close to
    exact as f32's) are not the plain version's bits; each bf16(p~) and
    dP near a rounding boundary may then round the other way, and at
    head dim 256 that moves a gradient more than 1e-4 from the plain
    backward. So does taking every product exactly (f64, rounded to f32
    once): the f32 limit measures closeness to the plain version's
    roundings, not accuracy. The kernel's logits are FMA chains that
    give the plain version's bits, and that algorithm holds the f32
    limits here."""
    from unittest import mock
    split, plain = _split_and_plain(WIDE, logits="tf32")
    rels = [_within(g, w, F32_LIMITS)[1] for g, w in zip(split, plain)]
    assert max(rels) > F32_LIMITS["rel_l2"], rels
    with mock.patch.object(t_ref, "_split_mm", lambda a, b, terms: (
            a.double() @ b.double()).float()):
        exact, _ = _split_and_plain(WIDE, logits="tf32")
    rels = [_within(g, w, F32_LIMITS)[1] for g, w in zip(exact, plain)]
    assert max(rels) > F32_LIMITS["rel_l2"], rels
    fma, _ = _split_and_plain(WIDE)
    for name, g, w in zip(("dq", "dk", "dv"), fma, plain):
        ok, rel = _within(g, w, F32_LIMITS)
        assert ok, (name, rel)
