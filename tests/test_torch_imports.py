"""The port stands alone: no JAX and no ``repro`` anywhere in
``src/repro_torch``, and entry points that run on the card unless the
caller asks for the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

PORT = Path(__file__).resolve().parent.parent / "src" / "repro_torch"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


PORT_FILES = sorted(PORT.rglob("*.py"))


def test_port_has_python_and_cuda_sources():
    assert len(PORT_FILES) > 15
    assert sorted(p.name for p in (PORT / "kernels" / "csrc").glob("*.cu")) \
        == ["coalesce_kernel.cu", "flash.cu", "flash_bwd.cu",
            "flash_decode.cu", "fused_round.cu", "pack.cu",
            "route_spans.cu", "sort.cu", "zero_skip.cu"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(PORT)))
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


EXAMPLES = sorted((PORT.parents[1] / "examples").glob("torch_*.py"))


def test_port_side_examples_and_checkers_are_scanned():
    assert [p.name for p in EXAMPLES] == [
        "torch_checkpoint_restart.py", "torch_quickstart.py",
        "torch_serve_batched.py", "torch_train_small_lm.py"]
    assert {p.name for p in PORT_FILES if p.parent.name == "testing"} == {
        "__init__.py", "rounds_checks.py", "spmd_checks.py"}


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_no_jax_or_reference_import_in_port_examples(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_importing_the_checkers_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch.testing.rounds_checks, "
            "repro_torch.testing.spmd_checks; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code],
                          env={"PYTHONPATH": str(PORT.parent),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch.core, repro_torch.kernels.ops, "
            "repro_torch.kernels.ref, repro_torch.io_patterns.generators, "
            "repro_torch.configs, repro_torch.models.transformer, "
            "repro_torch.models.weights, repro_torch.launch.serve, "
            "repro_torch.checkpoint.host_io, repro_torch.checkpoint.mp_exec, "
            "repro_torch.core.session, repro_torch.core.faults, "
            "repro_torch.core.transport, repro_torch.runtime.elastic, "
            "repro_torch.runtime.heartbeat, repro_torch.runtime.trainer, "
            "repro_torch.checkpoint.checkpoint, repro_torch.optim, "
            "repro_torch.data, repro_torch.launch.train, "
            "repro_torch.launch.steps, repro_torch.launch.shapes; "
            "[repro_torch.configs.get(a) for a in repro_torch.configs.ARCHS]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code],
                          env={"PYTHONPATH": str(PORT.parent),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _entry_points():
    from repro_torch.core import (IOConfig, RankMesh, contiguous_layout,
                                  make_collective_write, make_tam_read,
                                  make_tam_write, make_twophase_read,
                                  make_twophase_write, requests_from_numpy)
    from repro_torch import configs
    from repro_torch.checkpoint import HostCollectiveIO
    from repro_torch.models import transformer as T
    from repro_torch.models.config import reduced
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.train import build_training
    cfg_lm = reduced(configs.get("gemma2_9b"))
    mesh = RankMesh(2, 1, 2)
    layout = contiguous_layout(64, 2)
    cfg = IOConfig(req_cap=4, data_cap=16)
    O = np.zeros((4, 4), np.int32)
    C = np.zeros(4, np.int32)
    D = np.zeros((4, 16), np.int32)
    return {
        "twophase": lambda **kw: make_twophase_write(mesh, layout, cfg, **kw),
        "tam": lambda **kw: make_tam_write(mesh, layout, cfg, **kw),
        "collective": lambda **kw: make_collective_write(mesh, layout, cfg,
                                                         **kw),
        "twophase_read": lambda **kw: make_twophase_read(mesh, layout, cfg,
                                                         **kw),
        "tam_read": lambda **kw: make_tam_read(mesh, layout, cfg, **kw),
        "requests": lambda **kw: requests_from_numpy(O, O, C, D, **kw),
        "init_params": lambda **kw: T.init_params(0, cfg_lm, **kw),
        "init_decode_state": lambda **kw: T.init_decode_state(cfg_lm, 1, 4,
                                                              **kw),
        "params_from_numpy": lambda **kw: params_from_numpy(
            {"w": np.zeros(2, np.float32)}, **kw),
        "host_collective_io": lambda **kw: HostCollectiveIO(
            n_ranks=4, n_nodes=2, stripe_size=64, stripe_count=2, **kw),
        "token_pipeline": lambda **kw: SyntheticTokenPipeline(
            DataConfig(vocab=64, seq=4, global_batch=1), **kw),
        "build_training": lambda **kw: build_training(
            "gemma2_9b", smoke=True, steps=1, batch=1, seq=4, **kw),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_point_without_card_raises_unless_cpu_asked(name):
    make = _entry_points()[name]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(device="cuda")
    make(device="cpu")


def test_cpu_write_returns_cpu_tensors():
    from repro_torch.core import (IOConfig, RankMesh, contiguous_layout,
                                  make_twophase_write, requests_from_numpy)
    O = np.array([[0, 8], [16, 24]], np.int32)
    L = np.full((2, 2), 8, np.int32)
    C = np.array([2, 2], np.int32)
    D = np.arange(32, dtype=np.int32).reshape(2, 16) + 1
    write = make_twophase_write(RankMesh(2, 1, 1), contiguous_layout(32, 2),
                                IOConfig(req_cap=2, data_cap=16),
                                device="cpu")
    file, stats = write(*requests_from_numpy(O, L, C, D, device="cpu"))
    assert file.device.type == "cpu"
    np.testing.assert_array_equal(
        file.numpy().reshape(-1),
        np.concatenate([D[0, :8], D[0, 8:16], D[1, :8], D[1, 8:16]]))
    assert stats["requests_at_ga"].tolist() == [2, 2]
