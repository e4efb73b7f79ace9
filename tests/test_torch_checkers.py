"""The port's executable checkers at ``--device cpu``, on the CPU.

``python -m repro_torch.testing.rounds_checks --device cpu`` and
``... spmd_checks --device cpu`` each run in a subprocess with a time
limit of 300 s (about 10 s and 3 s here); each must exit 0 and print no
FAIL line. ``spmd_checks`` must print PASS for each of the 17 check
names of the reference's ``src/repro/testing/spmd_checks.py`` (found
with ``ast``), ``sharded_loss_matches_local`` included, which the
reference itself fails on this tree's JAX. ``rounds_checks`` must print
every substring that the reference's ``tests/test_rounds.py`` requires
of the reference's run (found with ``ast``), and 692 distinct check
names, as many as the reference's loops make: 4 patterns x 46 checks,
2 x 56 for the depth, codec, placement and fused-read rows of mixed and
spanning, 4 seeds x 96 fuzz checks, 11 for the mp executor and 1
overflow.

``spmd_checks``'s MoE checks take the reference's own draws, carried as
arrays in ``src/repro_torch/testing/moe_check_inputs.npz``;
``test_moe_check_inputs_are_the_reference_draws`` holds that file to
``init_moe(PRNGKey(0))`` and ``normal(PRNGKey(1))`` bit for bit, and
``python tests/test_torch_checkers.py`` writes it again.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
LIMIT_S = 300


def run_checker(name: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    return subprocess.run(
        [sys.executable, "-m", f"repro_torch.testing.{name}", "--device",
         "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=LIMIT_S)


def lines_of(proc) -> tuple[list[str], list[str]]:
    out = proc.stdout.splitlines()
    return ([ln[5:] for ln in out if ln.startswith("PASS ")],
            [ln for ln in out if ln.startswith("FAIL")])


def reference_spmd_names() -> list[str]:
    tree = ast.parse((ROOT / "src" / "repro" / "testing"
                      / "spmd_checks.py").read_text())
    return [node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "id", "") == "check"
            and isinstance(node.args[0], ast.Constant)]


def reference_rounds_substrings() -> list[str]:
    """The ``assert "..." in proc.stdout`` strings of the reference's
    ``test_rounds_spmd_checks``."""
    tree = ast.parse((ROOT / "tests" / "test_rounds.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "test_rounds_spmd_checks")
    return [node.test.left.value for node in ast.walk(fn)
            if isinstance(node, ast.Assert)
            and isinstance(node.test, ast.Compare)
            and isinstance(node.test.left, ast.Constant)
            and isinstance(node.test.ops[0], ast.In)]


@pytest.mark.timeout(LIMIT_S + 30)
def test_spmd_checks_pass_every_reference_check():
    names = reference_spmd_names()
    assert len(names) == 17 and "sharded_loss_matches_local" in names
    proc = run_checker("spmd_checks")
    passed, failed = lines_of(proc)
    assert proc.returncode == 0 and not failed, proc.stdout + proc.stderr
    assert passed == names
    assert proc.stdout.splitlines()[-1] == "0 failures"


@pytest.mark.timeout(LIMIT_S + 30)
def test_rounds_checks_pass_and_run_every_reference_row():
    wanted = reference_rounds_substrings()
    assert len(wanted) == 12
    proc = run_checker("rounds_checks")
    passed, failed = lines_of(proc)
    assert proc.returncode == 0 and not failed, proc.stdout + proc.stderr
    assert len(passed) == len(set(passed)) == 692
    for s in wanted:
        assert any(s in name for name in passed), s
    assert proc.stdout.splitlines()[-1] == "0 failures"


def test_checkers_default_to_the_card():
    """Without ``--device`` (and without a card) a checker raises rather
    than run on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    from repro_torch.testing import spmd_checks
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spmd_checks.run()


MOE_INPUTS = ROOT / "src" / "repro_torch" / "testing" / "moe_check_inputs.npz"


def reference_moe_inputs() -> dict:
    """The reference ``spmd_checks``' MoE parameters (``init_moe`` of
    ``PRNGKey(0)``, f32) and tokens (``normal`` of ``PRNGKey(1)``), as
    numpy arrays."""
    from dataclasses import replace as dreplace

    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro import configs
    from repro.models import layers as ML
    from repro.models.config import reduced
    cfg = reduced(configs.get("llama4_maverick"))
    cfg = dreplace(cfg, moe=dreplace(cfg.moe, capacity_factor=4.0),
                   d_model=32, vocab=256)
    params = ML.init_moe(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, 32), jnp.float32)
    return {**{k: np.asarray(v) for k, v in params.items()},
            "x": np.asarray(x)}


def test_moe_check_inputs_are_the_reference_draws():
    import numpy as np
    want = reference_moe_inputs()
    with np.load(MOE_INPUTS) as got:
        assert sorted(got.files) == sorted(want)
        for name, a in want.items():
            assert got[name].dtype == a.dtype and np.array_equal(
                got[name].view(np.uint32), a.view(np.uint32)), name


if __name__ == "__main__":
    import numpy as np
    np.savez_compressed(MOE_INPUTS, **reference_moe_inputs())
    print(f"wrote {MOE_INPUTS}")
