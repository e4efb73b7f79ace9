"""The slice as a whole: the port's collective writes on the CPU.

* Every pattern of the round-engine checks, across cb {160, 80, 32} on
  the 320-element file (1, 2 and 5 rounds), ring depth {1, 2, 3} and
  placement {None, (1, 0)}, through ``make_twophase_write`` and
  ``make_tam_write`` (with and without ``use_kernels``), each with
  ``kernel_fusion`` None and ``"fused_round"``: the file bytes equal
  ``write_reference`` and no request is dropped.
* The same cross with ``slow_hop_codec="rle"``: the wire is encoded
  and decoded around every node-axis hop (by the zero-skip kernels'
  plain versions when fused) and the bytes do not change.
* On a subset (:data:`JAX_CONFIGS`, drop cases, rle and ef-int8 writes
  included), the file and every stats key equal the reference's SPMD
  executor on 8 virtual CPU devices, run once in a subprocess (this
  file as a script) that writes all its outputs to one ``.npz``. The
  ef-int8 writes (a float32 payload) agree within one int8 step of the
  largest scale (``max|file| / 127``): the port follows the reference's
  float32 arithmetic, but XLA on the CPU may contract the residual's
  ``x - q * scale`` into a fused multiply-add. Measured: the two-phase
  write bit-equal, the TAM write off by at most 9.54e-7 (one float32
  ulp) on 10 of 320 elements, against a step of 1.1.
"""
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

FILE_LEN, P_RANKS, DATA_CAP = 320, 8, 64
CBS = (160, 80, 32)
DEPTHS = (1, 2, 3)
PLACEMENTS = (None, (1, 0))
CROSS_PATTERNS = ("mixed", "strided", "overlapping", "spanning", "random0",
                  "random1")

# (method, pattern, cb, depth, placement, kernel_fusion, use_kernels,
#  coalesce_cap, slow_hop_codec); ef-int8 writes the pattern's payload
# as float32 (:func:`payload_for`)
JAX_CONFIGS = [
    ("twophase", "mixed", 160, 1, None, None, False, 32, None),
    ("twophase", "strided", 80, 2, (1, 0), "fused_round", False, 32, None),
    ("twophase", "overflow", 32, 3, None, "fused_round", False, 32, None),
    ("twophase", "random1", 32, 1, (1, 0), None, False, 32, None),
    ("tam", "spanning", 160, 1, None, None, False, 32, None),
    ("tam", "overlapping", 32, 2, (1, 0), "fused_round", True, 32, None),
    ("tam", "random0", 80, 3, None, "fused_round", True, 32, None),
    ("tam", "overflow", 32, 1, (1, 0), None, True, 2, None),
    ("twophase", "random0", 32, 2, (1, 0), "fused_round", False, 32, "rle"),
    ("twophase", "overflow", 32, 1, None, None, False, 32, "rle"),
    ("tam", "mixed", 32, 3, None, "fused_round", True, 32, "rle"),
    ("twophase", "random1", 32, 3, None, None, False, 32, "ef-int8"),
    ("tam", "spanning", 80, 2, (1, 0), "fused_round", True, 32, "ef-int8"),
]


def _rounds_checks():
    """rounds_checks sets XLA_FLAGS when imported (it is meant to run as
    its own 8-device process); keep this process's environment as is."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.testing import rounds_checks
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return rounds_checks


def overflow_pattern():
    """Rank 0 writes one 20-element extent twice (identical payload),
    so a 32-element round bucket overflows by 8 elements; the other
    ranks write disjoint extents. The drops are deterministic."""
    pad = 2**31 - 1
    O = np.full((P_RANKS, 8), pad, np.int32)
    L = np.zeros((P_RANKS, 8), np.int32)
    C = np.zeros(P_RANKS, np.int32)
    D = np.zeros((P_RANKS, DATA_CAP), np.int32)
    O[0, :2], L[0, :2], C[0] = 0, 20, 2
    D[0, :20] = D[0, 20:40] = np.arange(1, 21)
    O[1, 0], L[1, 0], C[1] = 100, 30, 1
    D[1, :30] = np.arange(500, 530)
    for p in range(2, P_RANKS):
        O[p, 0], L[p, 0], C[p] = 170 + (p - 2) * 20, 12, 1
        D[p, :12] = 1000 * p + np.arange(12)
    return O, L, C, D


def patterns():
    rc = _rounds_checks()
    rng = np.random.default_rng(0)
    pats = {"mixed": rc.mixed_pattern(rng),
            "strided": rc.strided_pattern(rng),
            "overlapping": rc.overlapping_pattern(rng),
            "spanning": rc.spanning_pattern(rng),
            "overflow": overflow_pattern()}
    for seed in range(2):
        pats[f"random{seed}"] = rc.random_pattern(
            np.random.default_rng(2000 + seed))
    return pats


def _config(mod, cb, depth, placement, fusion, coalesce_cap, codec=None):
    return mod.IOConfig(req_cap=32, data_cap=DATA_CAP,
                        coalesce_cap=coalesce_cap, cb_buffer_size=cb,
                        pipeline=depth > 1, pipeline_depth=depth,
                        placement=placement, kernel_fusion=fusion,
                        slow_hop_codec=codec)


def payload_for(codec, pattern):
    """The pattern's arrays; a lossy codec writes its payload as
    float32 (scaled so it is not integral)."""
    O, L, C, D = pattern
    if codec == "ef-int8":
        D = D.astype(np.float32) / np.float32(7)
    return O, L, C, D


def _reference_outputs(out_path: str) -> None:
    """Run :data:`JAX_CONFIGS` through the reference's SPMD executor and
    save every file and stats value (run in an 8-device process)."""
    import jax

    from repro.core import plan as j_plan
    from repro.core.domains import contiguous_layout
    from repro.core.tam import make_tam_write
    from repro.core.twophase import make_twophase_write

    mesh = jax.make_mesh((2, 2, 2), ("node", "lagg", "lmem"))
    layout = contiguous_layout(FILE_LEN, 2)
    pats = patterns()
    out = {}
    for i, (method, pname, cb, depth, pl, fusion, uk, ccap,
            codec) in enumerate(JAX_CONFIGS):
        cfg = _config(j_plan, cb, depth, pl, fusion, ccap, codec)
        fn = (make_twophase_write(mesh, layout, cfg) if method == "twophase"
              else make_tam_write(mesh, layout, cfg, use_kernels=uk))
        file, stats = jax.jit(fn)(*payload_for(codec, pats[pname]))
        out[f"{i}/file"] = np.asarray(file)
        for k, v in stats.items():
            out[f"{i}/{k}"] = np.asarray(v)
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_outputs(sys.argv[1])
    sys.exit(0)


from repro_torch.core import plan as t_plan  # noqa: E402
from repro_torch.core import (RankMesh, contiguous_layout,  # noqa: E402
                              make_tam_write, make_twophase_write,
                              write_reference)

PATTERNS = patterns()
MESH = RankMesh(2, 2, 2)
LAYOUT = contiguous_layout(FILE_LEN, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only contends with JAX's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_writers(cfg):
    yield "twophase", make_twophase_write(MESH, LAYOUT, cfg, device="cpu")
    yield "tam", make_tam_write(MESH, LAYOUT, cfg, device="cpu")
    yield "tam/kernels", make_tam_write(MESH, LAYOUT, cfg, use_kernels=True,
                                        device="cpu")


def _check_writes(pname, cb, depth, placement, codec):
    O, L, C, D = PATTERNS[pname]
    ref = write_reference(LAYOUT, O, L, C, D)
    for fusion in (None, "fused_round"):
        cfg = _config(t_plan, cb, depth, placement, fusion, 32, codec)
        for name, write in _port_writers(cfg):
            assert write.plan.n_rounds == 160 // cb
            file, stats = write(O, L, C, D)
            assert file.shape == (2, 160) and file.dtype == torch.int32
            assert file.numpy().reshape(-1).tobytes() == ref.tobytes(), (
                name, fusion)
            assert int(stats["dropped_requests"]) == 0, (name, fusion)
            assert int(stats["dropped_elems"]) == 0, (name, fusion)


@pytest.mark.parametrize("placement", PLACEMENTS, ids=["identity", "swap"])
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("cb", CBS)
@pytest.mark.parametrize("pname", CROSS_PATTERNS)
def test_write_matches_reference_bytes(pname, cb, depth, placement):
    _check_writes(pname, cb, depth, placement, None)


@pytest.mark.parametrize("placement", PLACEMENTS, ids=["identity", "swap"])
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("cb", CBS)
@pytest.mark.parametrize("pname", CROSS_PATTERNS)
def test_rle_write_matches_reference_bytes(pname, cb, depth, placement):
    _check_writes(pname, cb, depth, placement, "rle")


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory, spmd_env):
    out = tmp_path_factory.mktemp("jax_write") / "reference.npz"
    proc = subprocess.run([sys.executable, __file__, str(out)], env=spmd_env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(out))


@pytest.mark.parametrize("i", range(len(JAX_CONFIGS)),
                         ids=["-".join(str(x) for x in c[:5])
                              + (f"-{c[8]}" if c[8] else "")
                              for c in JAX_CONFIGS])
def test_write_matches_reference_executor(jax_outputs, i):
    method, pname, cb, depth, pl, fusion, uk, ccap, codec = JAX_CONFIGS[i]
    cfg = _config(t_plan, cb, depth, pl, fusion, ccap, codec)
    write = (make_twophase_write(MESH, LAYOUT, cfg, device="cpu")
             if method == "twophase"
             else make_tam_write(MESH, LAYOUT, cfg, use_kernels=uk,
                                 device="cpu"))
    file, stats = write(*payload_for(codec, PATTERNS[pname]))
    want_file = jax_outputs[f"{i}/file"]
    assert file.shape == want_file.shape
    if codec == "ef-int8":
        assert file.numpy().dtype == want_file.dtype
        np.testing.assert_allclose(file.numpy(), want_file, rtol=0,
                                   atol=np.abs(want_file).max() / 127)
    else:
        assert file.numpy().tobytes() == want_file.tobytes()
    want_keys = {k.split("/", 1)[1] for k in jax_outputs
                 if k.startswith(f"{i}/")} - {"file"}
    assert set(stats) == want_keys
    for k in want_keys:
        got = stats[k].numpy()
        want = jax_outputs[f"{i}/{k}"]
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    if pname == "overflow":
        assert int(stats["dropped_elems"]) > 0


def test_overflow_is_reported_not_silent():
    O, L, C, D = PATTERNS["overflow"]
    cfg = _config(t_plan, 32, 1, None, "fused_round", 32)
    for name, write in _port_writers(cfg):
        _, stats = write(O, L, C, D)
        # two-phase drops the 8 elements past the round bucket; TAM
        # drops them once at the rank and once more at the aggregator
        assert int(stats["dropped_elems"]) == (8 if name == "twophase"
                                               else 16), name


@pytest.mark.parametrize("knob", ["codec", "read"])
def test_out_of_slice_paths_raise(knob):
    """The codec and read paths run now; what they refuse raises before
    any round runs: a lossy codec on an int32 payload, and a read plan
    bound to a mesh of another node count."""
    cfg = _config(t_plan, 32, 1, None, None, 32)
    if knob == "codec":
        cfg = replace(cfg, slow_hop_codec="ef-int8")
        write = make_twophase_write(MESH, LAYOUT, cfg, device="cpu")
        with pytest.raises(TypeError, match="lossy"):
            write(*PATTERNS["mixed"])
    else:
        from repro_torch.core.spmd_exec import make_spmd_executor
        from repro_torch.core.twophase import plan_for
        plan = plan_for(LAYOUT, cfg, 2, 8, direction="read")
        with pytest.raises(ValueError, match="aggregators"):
            make_spmd_executor(RankMesh(4, 1, 2), plan, device="cpu")


def test_jax_plan_runs_unchanged_on_the_port():
    """A plan compiled by the reference planner, carried over with
    plan_from_fields, runs on the port and writes the same bytes."""
    from repro.core import plan as j_plan
    from repro.core.domains import contiguous_layout as j_layout
    from repro_torch.core.spmd_exec import make_spmd_executor
    cfg = _config(j_plan, 32, 2, (1, 0), "fused_round", 32)
    ref_plan = j_plan.compile_plan(j_layout(FILE_LEN, 2), cfg,
                                   n_aggregators=2, n_nodes=2, n_ranks=8,
                                   method="tam")
    fields = {f: getattr(ref_plan, f) for f in
              ("n_aggregators", "cb", "n_rounds", "method", "direction",
               "pipeline_depth", "req_cap", "data_cap", "coalesce_cap",
               "axis_names", "tam_read_fallback", "slow_hop_codec",
               "placement", "kernel_fusion", "transport")}
    fields["layout"] = list(ref_plan.layout)
    plan = t_plan.plan_from_fields(fields)
    O, L, C, D = PATTERNS["random0"]
    file, _ = make_spmd_executor(MESH, plan, use_kernels=True,
                                 device="cpu")(O, L, C, D)
    assert (file.numpy().reshape(-1).tobytes()
            == write_reference(LAYOUT, O, L, C, D).tobytes())

