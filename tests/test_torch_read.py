"""The port's collective reads on the CPU.

* Every pattern of the round-engine checks, written with
  ``write_reference`` into the 320-element file, is read back through
  ``make_twophase_read`` and ``make_tam_read`` across cb {160, 80, 32}
  (1, 2 and 5 rounds), ring depth {1, 2, 3} and placement
  {None, (1, 0)}, each with ``kernel_fusion`` None and ``"fused_round"``
  and ``slow_hop_codec`` None and ``"rle"``: every rank gets back the
  payload it wrote.
* ``ef-int8`` reads of a float32 file stay within the 5e-2 band of
  ``tests/test_codec.py``.
* On a subset (:data:`READ_CONFIGS`), the payloads equal the
  reference's SPMD readers on 8 virtual CPU devices, run once in a
  subprocess (this file as a script): bit for bit, ef-int8 included
  (the read quantizes each window once, with no residual).
"""
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_write import (CBS, CROSS_PATTERNS, DEPTHS,  # noqa: E402
                              FILE_LEN, PLACEMENTS, _config, patterns,
                              payload_for)

# (method, pattern, cb, depth, placement, kernel_fusion, slow_hop_codec)
READ_CONFIGS = [
    ("twophase", "mixed", 160, 1, None, None, None),
    ("twophase", "spanning", 32, 2, (1, 0), None, "rle"),
    ("twophase", "random0", 32, 3, None, "fused_round", "rle"),
    ("twophase", "overlapping", 80, 2, (1, 0), "fused_round", None),
    ("tam", "strided", 32, 1, (1, 0), "fused_round", "rle"),
    ("tam", "random1", 80, 3, None, None, "identity"),
    ("twophase", "mixed", 32, 2, None, None, "ef-int8"),
    ("tam", "spanning", 80, 1, (1, 0), "fused_round", "ef-int8"),
    ("twophase", "wrap", 32, 2, (1, 0), None, None),
    ("tam", "wrap", 160, 1, None, "fused_round", "rle"),
]
EF_BAND = 5e-2


def wrap_pattern():
    """Reads at file positions the reference computes in int32: a
    request whose end wraps past 2^31 - 1, one past the file's end that
    does not wrap, one at negative offsets (domain -1, which jnp
    indexing wraps to the last domain), and ordinary ones."""
    big = 2**31 - 1
    O = np.full((8, 8), big, np.int32)
    L = np.zeros((8, 8), np.int32)
    C = np.zeros(8, np.int32)
    rows = {0: [(3, 10), (big - 3, 8)], 1: [(-40, 10), (50, 6)],
            2: [(big - 100, 6)], 3: [(310, 20)], 4: [(100, 40)],
            5: [(-2, 5), (big - 2, 5)], 6: [(161, 30)], 7: [(0, 64)]}
    for p, reqs in rows.items():
        for i, (o, n) in enumerate(reqs):
            O[p, i], L[p, i] = o, n
        C[p] = len(reqs)
    D = (np.arange(8 * 64, dtype=np.int32).reshape(8, 64) + 1) * 7
    return O, L, C, D


def read_patterns():
    return {**patterns(), "wrap": wrap_pattern()}


def _read_file(pname, pattern):
    """The file a :data:`READ_CONFIGS` row reads: what its pattern
    writes, or for ``wrap`` (whose requests leave the file) distinct
    values everywhere."""
    if pname == "wrap":
        return (np.arange(FILE_LEN, dtype=np.int32) * 3 + 1).reshape(2, -1)
    return _file_of(pattern)


def _file_of(pattern):
    from repro_torch.core import contiguous_layout, write_reference
    O, L, C, D = pattern
    return write_reference(contiguous_layout(FILE_LEN, 2), O, L, C,
                           D).reshape(2, -1)


def _reference_outputs(out_path: str) -> None:
    """Run :data:`READ_CONFIGS` through the reference's SPMD readers and
    save every payload (run in an 8-device process)."""
    import jax

    from repro.core import plan as j_plan
    from repro.core.domains import contiguous_layout
    from repro.core.tam import make_tam_read
    from repro.core.twophase import make_twophase_read

    mesh = jax.make_mesh((2, 2, 2), ("node", "lagg", "lmem"))
    layout = contiguous_layout(FILE_LEN, 2)
    pats = read_patterns()
    out = {}
    for i, (method, pname, cb, depth, pl, fusion, codec) in enumerate(
            READ_CONFIGS):
        cfg = _config(j_plan, cb, depth, pl, fusion, 32, codec)
        mk = make_twophase_read if method == "twophase" else make_tam_read
        O, L, C, D = payload_for(codec, pats[pname])
        out[str(i)] = np.asarray(jax.jit(mk(mesh, layout, cfg))(
            O, L, C, _read_file(pname, (O, L, C, D))))
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_outputs(sys.argv[1])
    sys.exit(0)


from repro_torch.core import plan as t_plan  # noqa: E402
from repro_torch.core import (RankMesh, contiguous_layout,  # noqa: E402
                              make_tam_read, make_twophase_read)

PATTERNS = read_patterns()
MESH = RankMesh(2, 2, 2)
LAYOUT = contiguous_layout(FILE_LEN, 2)
READERS = {"twophase": make_twophase_read, "tam": make_tam_read}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only contends with JAX's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_payloads(got, L, D, what):
    assert tuple(got.shape) == D.shape and got.dtype == torch.int32, what
    got = got.numpy()
    for p in range(D.shape[0]):
        n = int(L[p].sum())
        np.testing.assert_array_equal(got[p, :n], D[p, :n], err_msg=str(
            (what, p)))
        assert not got[p, n:].any(), (what, p)


@pytest.mark.parametrize("placement", PLACEMENTS, ids=["identity", "swap"])
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("cb", CBS)
@pytest.mark.parametrize("pname", CROSS_PATTERNS)
def test_read_returns_each_ranks_payload(pname, cb, depth, placement):
    """Overlapping writes leave the last writer's bytes in the file, so
    the payload is checked against what the file holds there."""
    O, L, C, D = PATTERNS[pname]
    file = _file_of(PATTERNS[pname])
    want = D.copy()
    for p in range(D.shape[0]):
        pos = 0
        for i in range(C[p]):
            o, n = int(O[p, i]), int(L[p, i])
            want[p, pos:pos + n] = file.reshape(-1)[o:o + n]
            pos += n
    for fusion in (None, "fused_round"):
        for codec in (None, "rle"):
            cfg = _config(t_plan, cb, depth, placement, fusion, 32, codec)
            for name, mk in READERS.items():
                read = mk(MESH, LAYOUT, cfg, device="cpu")
                assert read.plan.direction == "read"
                assert read.plan.n_rounds == 160 // cb
                got = read(O, L, C, torch.as_tensor(file))
                _assert_payloads(got, L, want, (name, fusion, codec))


def test_tam_read_records_its_fallback():
    cfg = _config(t_plan, 32, 1, None, None, 32)
    read = make_tam_read(MESH, LAYOUT, cfg, device="cpu")
    assert read.plan.method == "tam" and read.plan.tam_read_fallback


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("method", ["twophase", "tam"])
def test_ef_int8_read_within_band(method, depth):
    O, L, C, D = payload_for("ef-int8", PATTERNS["random0"])
    cfg = _config(t_plan, 32, depth, (1, 0), None, 32, "ef-int8")
    got = READERS[method](MESH, LAYOUT, cfg, device="cpu")(
        O, L, C, _file_of((O, L, C, D))).numpy()
    assert got.dtype == np.float32
    for p in range(D.shape[0]):
        n = int(L[p].sum())
        err = np.abs(got[p, :n] - D[p, :n]).max(initial=0)
        assert err <= EF_BAND * np.abs(D).max(), p


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory, spmd_env):
    out = tmp_path_factory.mktemp("jax_read") / "reference.npz"
    proc = subprocess.run([sys.executable, __file__, str(out)], env=spmd_env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(out))


@pytest.mark.parametrize("i", range(len(READ_CONFIGS)),
                         ids=["-".join(str(x) for x in c)
                              for c in READ_CONFIGS])
def test_read_matches_reference_executor(jax_outputs, i):
    method, pname, cb, depth, pl, fusion, codec = READ_CONFIGS[i]
    cfg = _config(t_plan, cb, depth, pl, fusion, 32, codec)
    O, L, C, D = payload_for(codec, PATTERNS[pname])
    got = READERS[method](MESH, LAYOUT, cfg, device="cpu")(
        O, L, C, _read_file(pname, (O, L, C, D))).numpy()
    want = jax_outputs[str(i)]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()
