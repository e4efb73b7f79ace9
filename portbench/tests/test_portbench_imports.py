"""Nothing of the benchmark loads JAX or the JAX package, and the
reference loads nothing of the program. Checked in fresh processes,
by whole top-level module names (``repro_torch`` begins with
``repro``)."""
import subprocess
import sys

from conftest import ROOT

LOAD_ALL = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from pathlib import Path
from portbench import harness, tracing, reference
for sub in ("metrics", "patterns"):
    for f in sorted((harness.HERE / sub).glob("*.py")):
        harness.load_module(f)
import portbench.run
"""
LOAD_REFERENCE = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import portbench.reference
from portbench import harness
for f in sorted((harness.HERE / "patterns").glob("*.py")):
    harness.load_module(f)
"""
TOP = "print(sorted({m.split('.')[0] for m in sys.modules}))"


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + TOP],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    return set(eval(out.strip().splitlines()[-1]))


def test_the_benchmark_loads_no_jax_and_no_reference_package():
    top = _top_level(LOAD_ALL)
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    top = _top_level(LOAD_REFERENCE)
    assert not top & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    from portbench import harness
    for m in [m for m in sys.modules
              if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    import repro_torch  # noqa: F401
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]
