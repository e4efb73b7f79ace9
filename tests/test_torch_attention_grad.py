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
