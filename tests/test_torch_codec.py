"""The port's slow-hop codecs against the reference's.

* The tensor hooks (``tensor_encode`` / ``tensor_decode`` /
  ``init_state``) of ``identity``, ``rle`` and ``ef-int8`` equal the
  reference's ``jax_encode`` / ``jax_decode`` / ``jax_init_state`` on
  the same numpy inputs: bit for bit for the lossless codecs, and for
  ``ef-int8`` the int8 codes, the float32 scales and the residual (the
  port's float32 arithmetic follows the reference's: max, divide by 127,
  divide, round half to even, clip).
* ``ef-int8`` writes of a float32 payload, both schedules, every depth,
  stay within the 5e-2 relative band of ``tests/test_codec.py`` against
  ``write_reference``; a lossy codec on an int32 payload raises
  ``TypeError`` before any round runs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import codec as j_codec  # noqa: E402

from repro_torch.core import codec as t_codec  # noqa: E402
from repro_torch.core import (IOConfig, RankMesh,  # noqa: E402
                              contiguous_layout, make_tam_write,
                              make_twophase_write, write_reference)
from repro_torch.io_patterns.generators import (  # noqa: E402
    btio_write_pattern)

EF_BAND = 5e-2        # tests/test_codec.py's relative band for ef-int8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only contends with JAX's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _payloads(rng, shape, dtype):
    x = rng.integers(-4, 5, size=shape) * (rng.random(shape) < 0.6)
    x = x.astype(dtype)
    if np.issubdtype(dtype, np.floating):
        x = x * np.float32(1.3)
        x.reshape(-1)[::11] = np.float32(-0.0)
    return x


@pytest.mark.parametrize("name", ["identity", "rle"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("shape", [(41,), (6, 37), (2, 3, 16)])
def test_lossless_tensor_hooks_match_reference(name, dtype, shape):
    x = _payloads(np.random.default_rng(sum(shape)), shape, dtype)
    tc, jc = t_codec.get_codec(name), j_codec.get_codec(name)
    t_parts, t_st = tc.tensor_encode(torch.as_tensor(x), ())
    j_parts, j_st = jc.jax_encode(jnp.asarray(x), ())
    assert t_st == () and j_st == ()
    assert len(t_parts) == len(j_parts)
    for tp, jp in zip(t_parts, j_parts):
        jp = np.asarray(jp)
        assert tp.numpy().dtype == jp.dtype and tp.shape == jp.shape
        assert tp.numpy().tobytes() == jp.tobytes()
    out = tc.tensor_decode(t_parts).numpy()
    assert out.tobytes() == np.asarray(jc.jax_decode(j_parts)).tobytes()
    np.testing.assert_array_equal(out, x)


@pytest.mark.parametrize("shape", [(17,), (4, 33), (3, 2, 65)])
def test_int8_encode_decode_match_reference(shape):
    rng = np.random.default_rng(len(shape))
    for scale in (1e-3, 1.0, 1e4):
        x = (rng.normal(size=shape) * scale).astype(np.float32)
        x.reshape(-1)[:3] = 0
        qt, st = t_codec.int8_encode(torch.as_tensor(x))
        qj, sj = j_codec.int8_encode(jnp.asarray(x))
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert st.numpy().tobytes() == np.asarray(sj).tobytes()
        assert (t_codec.int8_decode(qt, st).numpy().tobytes()
                == np.asarray(j_codec.int8_decode(qj, sj)).tobytes())


def test_int8_all_zero_rows_and_half_steps():
    """An all-zero row takes the 1e-30 floor; exact half steps round to
    even, as jnp.round does."""
    x = np.zeros((2, 8), np.float32)
    x[1] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3]
    qt, st = t_codec.int8_encode(torch.as_tensor(x))
    qj, sj = j_codec.int8_encode(jnp.asarray(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert qt[1].tolist() == [127, 0, 2, 2, 0, -2, -2, 3]
    assert st.numpy().tobytes() == np.asarray(sj).tobytes()


def test_ef_int8_residual_stream_matches_reference():
    """64 rounds of error feedback: every round's codes, scales and the
    carried residual equal the reference's, and the accumulated decode
    error stays inside one round's quantization error."""
    rng = np.random.default_rng(11)
    xs = rng.normal(size=(64, 4, 33)).astype(np.float32)
    tc, jc = t_codec.get_codec("ef-int8"), j_codec.get_codec("ef-int8")
    t_res = tc.init_state(xs[0].shape, torch.float32)
    j_res = jc.jax_init_state(xs[0].shape, jnp.float32)
    sent = np.zeros_like(xs[0])
    for x in xs:
        (tq, ts), t_res = tc.tensor_encode(torch.as_tensor(x), t_res)
        (jq, js), j_res = jc.jax_encode(jnp.asarray(x), j_res)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.numpy().tobytes() == np.asarray(js).tobytes()
        assert t_res.numpy().tobytes() == np.asarray(j_res).tobytes()
        sent += tc.tensor_decode((tq, ts)).numpy()
    err = np.abs(sent - xs.sum(0)).max() / np.abs(xs.sum(0)).max()
    assert err < EF_BAND
    assert np.allclose(sent + t_res.numpy(), xs.sum(0), atol=1e-4)


def test_ef_int8_state_rejects_int_payloads():
    ef = t_codec.get_codec("ef-int8")
    with pytest.raises(TypeError):
        ef.init_state((4, 8), torch.int32)
    assert ef.init_state((4, 8), torch.float32).dtype == torch.float32
    assert t_codec.get_codec("rle").init_state((4, 8), torch.int32) == ()


# ------------------------------------------------------- lossy writes

MESH = RankMesh(4, 1, 4)
LAYOUT = contiguous_layout(4 * 64 * 64 * 8, 4)


def _btio(dtype):
    O, L, C, D = btio_write_pattern(16, 64, 4, 8, seed=5)
    return O, L, C, D.astype(dtype)


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("method", ["twophase", "tam"])
def test_ef_int8_write_within_band(method, depth):
    O, L, C, D = _btio(np.float32)
    D = D / np.float32(1 << 20)
    ref = write_reference(LAYOUT, O, L, C, D)
    cfg = IOConfig(req_cap=O.shape[1], data_cap=D.shape[1],
                   coalesce_cap=64, cb_buffer_size=4096,
                   pipeline=depth > 1, pipeline_depth=depth,
                   slow_hop_codec="ef-int8")
    mk = make_twophase_write if method == "twophase" else make_tam_write
    file, stats = mk(MESH, LAYOUT, cfg, device="cpu")(O, L, C, D)
    got = file.numpy().reshape(-1)
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() / np.abs(ref).max() < EF_BAND
    assert int(stats["dropped_elems"]) == 0
    # lossy: not the identity, but every element is touched
    assert not np.array_equal(got, ref)


@pytest.mark.parametrize("method", ["twophase", "tam"])
def test_lossy_codec_on_int_payload_raises(method):
    O, L, C, D = _btio(np.int32)
    cfg = IOConfig(req_cap=O.shape[1], data_cap=D.shape[1],
                   coalesce_cap=64, cb_buffer_size=4096,
                   slow_hop_codec="ef-int8")
    mk = make_twophase_write if method == "twophase" else make_tam_write
    with pytest.raises(TypeError, match="lossy"):
        mk(MESH, LAYOUT, cfg, device="cpu")(O, L, C, D)


def _narrow_payloads(D):
    """bfloat16 and uint8 payloads from an int32 one, zero where it is."""
    bf = torch.from_numpy(D).to(torch.float32).to(torch.bfloat16)
    u8 = torch.from_numpy(np.where(D == 0, 0, D % 255 + 1).astype(np.uint8))
    return bf, u8


def _bytes(t):
    return t.contiguous().view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("fusion", [None, "fused_round"])
@pytest.mark.parametrize("method", ["twophase", "tam"])
def test_rle_narrow_payloads_keep_every_bit(method, fusion):
    """rle writes and reads of 2- and 1-byte payloads on the CPU: the
    file equals ``write_reference`` on the payload's bits byte for byte,
    and reading back a file whose bfloat16 payload holds NaNs with a
    payload (bits 0x7fc1, which torch's CPU gather and scatter of
    bfloat16 would turn into 0xffff: the port moves payloads as
    integers) returns each rank's payload bit for bit. (A write merges
    windows by a masked max, as the reference's pmax does, so a NaN's
    bits in a write are the merge's, not the payload's.)"""
    from repro_torch.core import make_tam_read, make_twophase_read
    O, L, C, D = btio_write_pattern(16, 64, 4, 8, seed=5)
    D = D.copy()
    cells = D.reshape(D.shape[0], -1, 8)
    cells[np.random.default_rng(5).random(cells.shape[:2]) < 0.5] = 0
    layout = contiguous_layout(4 * 64 * 64 * 8, 4)
    mesh = RankMesh(4, 1, 4)
    write = {"twophase": make_twophase_write, "tam": make_tam_write}[method]
    read = {"twophase": make_twophase_read, "tam": make_tam_read}[method]
    for P in _narrow_payloads(D):
        bits = P.view(torch.int16 if P.element_size() == 2 else torch.uint8)
        cfg = IOConfig(req_cap=O.shape[1], data_cap=P.shape[1],
                       coalesce_cap=64, cb_buffer_size=4096,
                       kernel_fusion=fusion, slow_hop_codec="rle")
        f, stats = write(mesh, layout, cfg, device="cpu")(O, L, C, P)
        assert f.dtype == P.dtype
        assert _bytes(f) == write_reference(layout, O, L, C,
                                            bits.numpy()).tobytes()
        assert int(stats["dropped_elems"].sum()) == 0
        if P.dtype == torch.bfloat16:
            P = P.clone()
            P.view(torch.int16)[:, 5::97] = 0x7fc1
        file = torch.from_numpy(write_reference(
            layout, O, L, C, P.view(bits.dtype).numpy())).view(P.dtype)
        got = read(mesh, layout, cfg, device="cpu")(O, L, C,
                                                    file.reshape(4, -1))
        for p in range(P.shape[0]):
            n = int(L[p].sum())
            assert _bytes(got[p, :n]) == _bytes(P[p, :n])
