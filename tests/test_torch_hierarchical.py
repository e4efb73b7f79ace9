"""The port's two-layer collectives (``repro_torch.core.hierarchical``,
on the rank axes of ``repro_torch.compat``) against the reference's
under ``shard_map``, on the CPU.

The reference runs once in an 8-device subprocess (this file as a
script, the ``spmd_env`` fixture) on a ``(pod, ici)`` mesh of (2, 4)
and (4, 2), and saves its outputs; the port runs the same seeded numpy
inputs on ``device="cpu"``. The cases are those of
``repro.testing.spmd_checks`` (a 33-long f32 leaf a rank; the int32
all-to-all whose global result is the flat transpose) and more: a
length that is a multiple of q, a one-element leaf, a 2-D leaf, and
bfloat16 payloads for the all-to-all. What must hold:

* ``two_layer_all_to_all`` equals the reference bit for bit, and the
  flat transpose;
* ``two_layer_psum`` is within f32 reassociation of the reference:
  max |diff| <= 1e-6 x max |sum|;
* ``compressed_psum`` over two steps with the residual fed back meets
  ``spmd_checks``' bounds (relative error < 5e-2, residual nonzero), and
  its output and residual lie within one int8 step of the reference's
  (the largest scale of the step's shards);
* the tree forms equal a leaf-by-leaf loop.
"""
import subprocess
import sys

import numpy as np
import pytest

GRIDS = ((2, 4), (4, 2))                 # (pod, ici)
LEAVES = {"len33": (33,), "len32": (32,), "len1": (1,), "2d": (5, 7)}
A2A = (("int32", 5), ("bfloat16", 3))    # payload type, elements a chunk
AXES = ("pod", "ici")


def leaf_inputs(shape, seed):
    """Eight ranks' f32 leaves ``[8, *shape]``, two steps of them."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(8, *shape)).astype(np.float32)
            for _ in range(2)]


def a2a_input(dtype, tail):
    """``[8, 8 * tail]``: rank r's chunk d holds distinct values (bf16
    payloads as their uint16 bit patterns, whole numbers below 256 that
    bf16 holds exactly)."""
    x = np.arange(8 * 8 * tail, dtype=np.int32).reshape(8, 8 * tail)
    return x if dtype == "int32" else (x % 256).astype(np.float32)


def _case_id(grid, name):
    return f"{grid[0]}x{grid[1]}-{name}"


def _reference_outputs(out_path: str) -> None:
    """Every case through the reference's collectives (an 8-device
    process)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core.hierarchical import (compressed_psum,
                                         two_layer_all_to_all,
                                         two_layer_psum)
    out = {}
    ranks = P(AXES)
    for grid in GRIDS:
        mesh = jax.make_mesh(grid, AXES)
        for name, shape in LEAVES.items():
            x1, x2 = leaf_inputs(shape, len(name))
            cid = _case_id(grid, name)
            out["psum-" + cid] = np.asarray(jax.jit(shard_map(
                lambda xs: two_layer_psum(xs.reshape(shape), "ici", "pod"),
                mesh=mesh, in_specs=ranks, out_specs=P(),
                check_vma=False))(x1))

            def step(xs, rs):
                o, r = compressed_psum(xs.reshape(shape), rs.reshape(shape),
                                       "ici", "pod")
                return o, r[None]
            cp = jax.jit(shard_map(step, mesh=mesh, in_specs=(ranks, ranks),
                                   out_specs=(P(), ranks), check_vma=False))
            o1, r1 = cp(x1, jnp.zeros_like(x1))
            o2, r2 = cp(x2, r1)
            for key, v in (("o1", o1), ("r1", r1), ("o2", o2), ("r2", r2)):
                out[f"cp-{key}-{cid}"] = np.asarray(v)
        for dtype, tail in A2A:
            x = jnp.asarray(a2a_input(dtype, tail)).astype(dtype)
            r = jax.jit(shard_map(
                lambda xs: two_layer_all_to_all(
                    xs.reshape(8, tail), "ici", "pod").reshape(1, -1),
                mesh=mesh, in_specs=ranks, out_specs=ranks,
                check_vma=False))(x)
            if dtype == "bfloat16":
                r = jax.lax.bitcast_convert_type(r, jnp.uint16)
            out["a2a-" + _case_id(grid, dtype)] = np.asarray(r)
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_outputs(sys.argv[1])
    sys.exit(0)


torch = pytest.importorskip("torch")

from repro_torch import compat as C  # noqa: E402
from repro_torch.compat import EmulatedMesh, P  # noqa: E402
from repro_torch.core import hierarchical as H  # noqa: E402

LEAF_CASES = [(g, n) for g in GRIDS for n in LEAVES]
A2A_CASES = [(g, dt, tail) for g in GRIDS for dt, tail in A2A]


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory, spmd_env):
    out = tmp_path_factory.mktemp("jax_hier") / "reference.npz"
    proc = subprocess.run([sys.executable, __file__, str(out)], env=spmd_env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(out))


def _ranks(grid):
    return C.Ranks.of(EmulatedMesh(grid, AXES), AXES)


def _per_rank(x, grid):
    """Global ``[8, *shape]`` (rank = pod-major) as ``[pod, ici,
    *shape]``."""
    R = _ranks(grid)
    t = C.to_ranks(torch.from_numpy(x), R, P(AXES))
    return t.reshape(*grid, *x.shape[1:])


def _one(t, grid):
    """A result every rank holds, as one tensor (checks that it is)."""
    full = t.expand(*grid, *t.shape[2:])
    assert bool((full == full[:1, :1]).all())
    return full[0, 0]


@pytest.mark.parametrize("grid,name", LEAF_CASES,
                         ids=[_case_id(g, n) for g, n in LEAF_CASES])
def test_two_layer_psum_matches_reference(jax_outputs, grid, name):
    x1, _ = leaf_inputs(LEAVES[name], len(name))
    got = _one(H.two_layer_psum(_per_rank(x1, grid), _ranks(grid), "ici",
                                "pod"), grid).numpy()
    want = jax_outputs["psum-" + _case_id(grid, name)]
    exact = x1.astype(np.float64).sum(0)
    assert got.shape == want.shape == LEAVES[name]
    bound = 1e-6 * np.abs(want).max()
    assert np.abs(got - want).max() <= bound
    assert np.abs(got - exact).max() <= 4 * bound + 1e-6


@pytest.mark.parametrize("grid,name", LEAF_CASES,
                         ids=[_case_id(g, n) for g, n in LEAF_CASES])
def test_compressed_psum_two_steps_match_reference(jax_outputs, grid, name):
    shape = LEAVES[name]
    x1, x2 = leaf_inputs(shape, len(name))
    R = _ranks(grid)
    cid = _case_id(grid, name)
    res = torch.zeros(*grid, *shape)
    for key, x in (("1", x1), ("2", x2)):
        xt = _per_rank(x, grid)
        # one int8 step of this call: a bound on every shard's scale
        step = float((xt.sum(1).abs().max() + res.abs().max()) / 127)
        out, res = H.compressed_psum(xt, res, R, "ici", "pod")
        out = _one(out, grid).numpy()
        res = res.expand(*grid, *shape)
        want_o = jax_outputs[f"cp-o{key}-{cid}"]
        want_r = jax_outputs[f"cp-r{key}-{cid}"].reshape(*grid, *shape)
        exact = x.sum(0)
        rel = np.abs(out - exact).max() / np.abs(exact).max()
        assert rel < 5e-2, rel                      # spmd_checks' bound
        if np.prod(shape) > grid[1]:
            assert float(res.abs().sum()) > 0       # the residual rides
        else:           # one element a shard: its scale codes it exactly
            assert float(res.abs().sum()) == 0
        assert np.abs(out - want_o).max() <= step
        assert np.abs(res.numpy() - want_r).max() <= step


@pytest.mark.parametrize("grid,dtype,tail", A2A_CASES,
                         ids=[_case_id(g, d) for g, d, _ in A2A_CASES])
def test_two_layer_all_to_all_bit_equal(jax_outputs, grid, dtype, tail):
    x = a2a_input(dtype, tail)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    R = _ranks(grid)
    ranked = C.to_ranks(xt, R, P(AXES)).reshape(*grid, 8, tail)
    got = C.from_ranks(H.two_layer_all_to_all(ranked, R, "ici", "pod")
                       .reshape(*grid, 1, 8 * tail), R, P(AXES))
    flat = xt.reshape(8, 8, tail).transpose(0, 1).reshape(8, 8 * tail)
    assert torch.equal(got, flat)
    bits = got if dtype == "int32" else got.view(torch.int16)
    want = jax_outputs["a2a-" + _case_id(grid, dtype)]
    np.testing.assert_array_equal(bits.numpy().view(want.dtype), want)


def test_two_layer_all_to_all_moves_every_chunk_to_its_rank():
    """The dispatch buckets' form: rank r's chunk d lands at rank d's
    chunk r, for chunks of several dims."""
    grid = (2, 4)
    R = _ranks(grid)
    x = torch.arange(8 * 8 * 3 * 2).reshape(*grid, 8, 3, 2)
    got = H.two_layer_all_to_all(x, R, "ici", "pod").reshape(8, 8, 3, 2)
    assert torch.equal(got, x.reshape(8, 8, 3, 2).transpose(0, 1))


def test_two_layer_all_to_all_wrong_length_raises():
    R = _ranks((2, 4))
    with pytest.raises(ValueError, match="n_slow"):
        H.two_layer_all_to_all(torch.zeros(2, 4, 6, 3), R, "ici", "pod")


def test_compressed_psum_propagates_a_nan_from_a_shard():
    grid = (2, 4)
    x = torch.ones(*grid, 8)
    x[1, 2, 5] = float("nan")
    out, _ = H.compressed_psum(x, torch.zeros_like(x), _ranks(grid), "ici",
                               "pod")
    nan = torch.isnan(out.expand(*grid, 8))
    # the NaN's shard (elements 4 and 5) shares one int8 scale
    assert bool(nan[..., 4:6].all())
    assert not bool(nan[..., :4].any() or nan[..., 6:].any())


def _tree(grid, seed):
    rng = np.random.default_rng(seed)
    return {"b": [torch.from_numpy(rng.normal(size=(*grid, 9)).astype(
                np.float32)),
                  torch.from_numpy(rng.normal(size=(*grid, 3, 4)).astype(
                      np.float32))],
            "a": torch.from_numpy(rng.normal(size=(*grid, 7)).astype(
                np.float32))}


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_tree_forms_equal_a_leaf_loop(grid):
    R = _ranks(grid)
    tree = _tree(grid, 1)
    got = H.tree_two_layer_psum(tree, R, "ici", "pod")
    assert torch.equal(got["a"], H.two_layer_psum(tree["a"], R, "ici",
                                                  "pod"))
    for g, leaf in zip(got["b"], tree["b"]):
        assert torch.equal(g, H.two_layer_psum(leaf, R, "ici", "pod"))
    res = {"b": [torch.zeros_like(t) for t in tree["b"]],
           "a": torch.zeros_like(tree["a"])}
    out, new_res = H.tree_compressed_psum(tree, res, R, "ici", "pod")
    for key in ("a",):
        o, r = H.compressed_psum(tree[key], res[key], R, "ici", "pod")
        assert torch.equal(out[key], o) and torch.equal(new_res[key], r)
    for i in range(2):
        o, r = H.compressed_psum(tree["b"][i], res["b"][i], R, "ici", "pod")
        assert torch.equal(out["b"][i], o)
        assert torch.equal(new_res["b"][i], r)


def test_int8_aliases_are_the_codec():
    x = torch.tensor([[0.5, -1.0, 0.25], [3.0, 0.0, -3.0]])
    q, scale = H._int8_encode(x)
    assert q.dtype == torch.int8 and scale.shape == (2,)
    assert torch.allclose(H._int8_decode(q, scale), x, atol=float(scale.max()))
