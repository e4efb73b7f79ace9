"""The arithmetic of the f32 attention route ``tc_f32`` on the CPU.

``kernels.ref.flash_attention_tc_f32_ref`` models what
``csrc/flash.cu``'s ``tc_f32`` kernel computes: q . k as split TF32
tensor-core products (three terms), the online softmax over the
kernel's 32-key tiles and 64-row blocks, p and v rounded to bf16 for
p.v with an f32 sum, l from the unrounded p. On seeded numpy inputs
(head dims 37, 64, 256; 1, 2 and 7 query heads a kv head; causal,
window, softcap, ``q_offset``, ``kv_len``) it is held to the plain
version, ``ref.flash_attention_ref``, and to the reference's
``repro.models.layers.flash_attention`` (not its Pallas kernel, which
fails on this tree's JAX) at the f32 check the card holds the kernel
to: every element within 5e-3 (absolute and relative) and a relative L2
distance of at most 1e-2. ``test_torch_cuda.py`` holds the kernel to
this model and to the plain version on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models.layers import flash_attention as j_attention  # noqa: E402

from repro_torch.kernels import ref as t_ref  # noqa: E402

TOL = 5e-3       # every element, absolute and relative
REL_L2 = 1e-2    # the whole output


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


def err(got, want):
    """``(worst element's share of its limit, relative L2)``."""
    g, w = (torch.as_tensor(x).float() for x in (got, want))
    worst = float(((g - w).abs() / (TOL + TOL * w.abs())).max())
    return worst, float((g - w).norm() / w.norm())


def within(got, want):
    worst, rel = err(got, want)
    return worst <= 1.0 and rel <= REL_L2


# (b, sq, skv, hq, hkv, hd, causal, window, cap, q_offset, kv_len): every
# row sees at least one key
CASES = {
    "hd37_g7_causal": (1, 40, 40, 7, 1, 37, True, None, None, 0, None),
    "hd37_g2_kv_len": (1, 33, 50, 4, 2, 37, False, None, 30.0, 0, 45),
    "hd64_g2_window": (2, 70, 70, 4, 2, 64, True, 16, None, 0, None),
    "hd64_g1_decode": (1, 5, 80, 2, 2, 64, True, None, 30.0, 60, 70),
    "hd256_g2_softcap": (1, 96, 96, 4, 2, 256, True, None, 50.0, 0, None),
    "hd256_g7_window_offset": (1, 20, 100, 7, 1, 256, True, 24, 50.0, 70,
                               None),
    "hd256_g1_noncausal": (1, 48, 65, 2, 2, 256, False, None, None, 0,
                           None),
}


def _run(case, seed=0):
    b, sq, skv, hq, hkv, hd, causal, window, cap, q_offset, kv_len = case
    q, k, v = mk(b, sq, skv, hq, hkv, hd, seed)
    kw = dict(causal=causal, window=window, logit_cap=cap,
              q_offset=q_offset, kv_len=kv_len)
    return (q, k, v), kw


@pytest.mark.parametrize("name", sorted(CASES))
def test_tc_f32_model_equals_the_plain_version(name):
    (q, k, v), kw = _run(CASES[name])
    t = [torch.from_numpy(x) for x in (q, k, v)]
    got = t_ref.flash_attention_tc_f32_ref(*t, **kw)
    want = t_ref.flash_attention_ref(*t, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert within(got, want), err(got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tc_f32_model_equals_the_reference_attention(name):
    (q, k, v), kw = _run(CASES[name], seed=1)
    got = t_ref.flash_attention_tc_f32_ref(
        *(torch.from_numpy(x) for x in (q, k, v)), **kw)
    want = np.array(j_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                **kw), np.float32)
    assert within(got, want), err(got, want)


def test_tc_f32_model_walks_only_visible_tiles():
    """Row blocks of a long causal window start their walk past key 0
    (the model walks the kernel's tiles): they give the plain result,
    and the same walk with a narrower window does not (the check sees
    a wrong mask)."""
    case = (1, 300, 300, 2, 1, 64, True, 40, None, 0, None)
    (q, k, v), kw = _run(case, seed=3)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    want = t_ref.flash_attention_ref(*t, **kw)
    assert within(t_ref.flash_attention_tc_f32_ref(*t, **kw), want)
    short = t_ref.flash_attention_tc_f32_ref(*t, **{**kw, "window": 8})
    assert not within(short, want)


def test_single_tf32_logits_at_head_dim_256():
    """What one TF32 product of q . k (``terms=1``: 10 mantissa bits of
    each operand) does at hd 256: on unit-normal inputs (logits of
    about unit size) it stays inside the f32 check, using more of it
    than the split product; with logits four times larger (q scaled by
    4) an element leaves the 5e-3 limit, while the split product keeps
    within it. The error of one TF32 product grows with the logits'
    size, the split one's stays near f32's: so the kernel's logits are
    split."""
    (q, k, v), kw = _run((1, 256, 256, 4, 2, 256, True, None, None, 0,
                          None))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    for scale, single_holds in ((1.0, True), (4.0, False)):
        qs = t[0] * scale
        want = t_ref.flash_attention_ref(qs, t[1], t[2], **kw)
        split = t_ref.flash_attention_tc_f32_ref(qs, t[1], t[2], **kw)
        single = t_ref.flash_attention_tc_f32_ref(qs, t[1], t[2], terms=1,
                                                  **kw)
        assert within(split, want), err(split, want)
        assert within(single, want) == single_holds, err(single, want)
        assert err(split, want)[0] < err(single, want)[0]


def test_model_tiles_are_the_kernels():
    """The model walks the kernel's tiles only while its ``F32_ROWS`` and
    ``F32_KEYS`` are the kernel's ``F32Tile::kRows`` and ``kKeys``
    (``flash._route`` sizes the grid by ``F32_ROWS`` too)."""
    import re
    from pathlib import Path

    from repro_torch.kernels import flash as t_flash
    src = (Path(t_flash.__file__).parent / "csrc" / "flash.cu").read_text()
    tile = src[src.index("struct F32Tile"):]
    tile = tile[:tile.index("};")]
    consts = dict(re.findall(r"constexpr int (kRows|kKeys) = (\d+);", tile))
    assert consts == {"kRows": str(t_ref.F32_ROWS),
                      "kKeys": str(t_ref.F32_KEYS)}
