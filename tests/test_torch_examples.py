"""The port's examples (``examples/torch_*.py``) at ``--device cpu``.

Each runs in a subprocess with a time limit of 300 s and must exit 0
and print the summary lines of its JAX twin (``examples/<name>.py``):
the quickstart's identical files, both schedules and the paper-scale
table (about 3 s); the batched serve's generate and sample lines (about
3 s); the kill-and-recover run's detection, elastic plan and recovered
loss equal to the control's (80 + 80 steps of reduced glm4, about 20
s); the small LM's parameter count and loss line (8 steps of reduced
yi-34b, about 10 s). Each writes only under a temporary directory.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
LIMIT_S = 300
CASES = {
    "torch_quickstart": ([], ["files identical: True", "two-phase:",
                              "TAM      :", "--- paper scale", "E3SM-F",
                              "S3D-IO"]),
    "torch_serve_batched": ([], ["arch=gemma2-9b-smoke generated (4, 13)",
                                 "sample:"]),
    "torch_checkpoint_restart": ([], [
        "control final loss:", "detected: host failure: [2] at latest "
        "checkpoint step 40", "elastic plan: mesh (2, 4)", "recovered loss",
        "OK: kill-and-recover run matches uninterrupted control"]),
    "torch_train_small_lm": (["--steps", "8"], ["arch=yi-34b-smoke",
                                                "steps=8", "done: loss"]),
}


@pytest.mark.timeout(LIMIT_S + 30)
@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_cpu(name, tmp_path):
    args, lines = CASES[name]
    env = dict(os.environ, TMPDIR=str(tmp_path))
    env.pop("PYTHONPATH", None)   # the example puts src/ on its path
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"), "--device",
         "cpu", *args], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=LIMIT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    for line in lines:
        assert line in proc.stdout, (line, proc.stdout)
    # nothing is left behind in the temporary directory it was given
    assert not any(tmp_path.iterdir()), list(tmp_path.iterdir())


def test_examples_default_to_the_card():
    """Without ``--device`` (and without a card) an example fails rather
    than run on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_quickstart.py")],
        capture_output=True, text=True, timeout=LIMIT_S)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
