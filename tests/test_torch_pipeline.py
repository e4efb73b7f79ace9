"""The port's GPipe pipeline (``repro_torch.models.pipeline``, on the
rank axis of ``repro_torch.compat``) against the reference's
``pipeline_apply`` under ``shard_map``, and against sequential
application, on the CPU.

The reference runs once in an 8-device subprocess (this file as a
script, the ``spmd_env`` fixture) on ``pipe`` meshes of S = 2 and 4
devices (the case of ``tests/test_pipeline.py``: ``tanh(x @ W[s])``
stages, 16 wide) with M = 1, 3 and 8 microbatches of 4 rows. The port's
output equals sequential application of the stages bit for bit (the
same calls on the same rows) and the reference's within 1e-5 (its
test's bound); every stage runs once a round, S + M - 1 rounds.
"""
import subprocess
import sys

import numpy as np
import pytest

CASES = [(s, m) for s in (2, 4) for m in (1, 3, 8)]
MB, D = 4, 16


def case_inputs(S, M):
    rng = np.random.default_rng(10 * S + M)
    W = (rng.normal(size=(S, D, D)) * 0.3).astype(np.float32)
    x = rng.normal(size=(M * MB, D)).astype(np.float32)
    return W, x


def _reference_outputs(out_path: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro.models.pipeline import pipeline_apply

    out = {}
    for S, M in CASES:
        mesh = jax.make_mesh((S,), ("pipe",), devices=jax.devices()[:S])
        W, x = case_inputs(S, M)
        fn = pipeline_apply(lambda w, xb: jnp.tanh(xb @ w), mesh,
                            microbatches=M)
        out[f"{S}-{M}"] = np.asarray(jax.jit(fn)(W, x))
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_outputs(sys.argv[1])
    sys.exit(0)


torch = pytest.importorskip("torch")

from repro_torch.compat import EmulatedMesh  # noqa: E402
from repro_torch.models.pipeline import pipeline_apply  # noqa: E402


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory, spmd_env):
    out = tmp_path_factory.mktemp("jax_pipe") / "reference.npz"
    proc = subprocess.run([sys.executable, __file__, str(out)], env=spmd_env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(out))


def _run(S, M):
    W, x = (torch.from_numpy(t) for t in case_inputs(S, M))
    calls = []

    def stage_fn(w, xb):
        calls.append(xb.shape)
        return torch.tanh(xb @ w)
    y = pipeline_apply(stage_fn, EmulatedMesh((S,), ("pipe",)),
                       microbatches=M)(W, x)
    return W, x, y, calls


@pytest.mark.parametrize("S,M", CASES, ids=[f"S{s}-M{m}" for s, m in CASES])
def test_pipeline_matches_reference_and_sequential(jax_outputs, S, M):
    W, x, y, calls = _run(S, M)
    assert len(calls) == S * (S + M - 1)
    assert all(c == (MB, D) for c in calls)
    seq = x
    for s in range(S):
        seq = torch.tanh(seq @ W[s])
    assert torch.equal(y, seq)
    np.testing.assert_allclose(y.numpy(), jax_outputs[f"{S}-{M}"],
                               atol=1e-5, rtol=0)


def test_pipeline_takes_a_tree_of_stage_params():
    """Each stage gets its slice of every leaf of a parameter tree."""
    S, M = 2, 3
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(S, D, D, generator=g) * 0.3,
              "b": [torch.randn(S, D, generator=g)]}
    x = torch.randn(M * MB, D, generator=g)
    y = pipeline_apply(lambda p, xb: torch.tanh(xb @ p["w"] + p["b"][0]),
                       EmulatedMesh((S,), ("pipe",)), microbatches=M)(
        params, x)
    seq = x
    for s in range(S):
        seq = torch.tanh(seq @ params["w"][s] + params["b"][0][s])
    assert torch.equal(y, seq)


def test_pipeline_batch_must_split_over_the_stages():
    with pytest.raises(ValueError, match="does not divide"):
        pipeline_apply(lambda w, xb: xb, EmulatedMesh((4,), ("pipe",)),
                       microbatches=3)(torch.zeros(4, 1, 1),
                                       torch.zeros(6, 2))
