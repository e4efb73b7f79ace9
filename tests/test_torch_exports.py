"""The reference's public names and CLI flags on the port, on the CPU.

* Every name an ``__init__.py`` under ``src/repro/`` exports (its
  imports, definitions and assignments, read with ``ast``: no JAX is
  imported) is an attribute of the port's package of the same path.
* ``requests.is_sorted`` and ``requests.to_numpy`` equal the
  reference's on seeded request lists (sorted, unsorted, with padding
  past the count, empty), and ``empty_requests`` its padding.
* Every flag the reference's ``launch/serve.py`` CLI declares
  (``add_argument`` in its ``main``, read with ``ast``) parses in the
  port's serve CLI, ``--smoke`` included.

About 5 s.
"""
import ast
import importlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import requests as j_rq  # noqa: E402

from repro_torch.core import requests as t_rq  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
INITS = sorted((SRC / "repro").rglob("__init__.py"))


def exported_names(path: Path) -> list[str]:
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return names


def port_module(path: Path) -> str:
    rel = path.parent.relative_to(SRC / "repro")
    return ".".join(("repro_torch", *rel.parts))


@pytest.mark.timeout(60)
@pytest.mark.parametrize("init", INITS, ids=[port_module(p) for p in INITS])
def test_every_reference_export_is_on_the_port(init):
    mod = importlib.import_module(port_module(init))
    missing = [n for n in exported_names(init) if not hasattr(mod, n)]
    assert not missing, missing


def test_the_core_exports_the_reference_lacked_until_now():
    """The names this check was written for (a parse that found no
    names would pass the test above)."""
    names = exported_names(SRC / "repro" / "core" / "__init__.py")
    for n in ("IOSession", "empty_requests", "Machine", "Workload",
              "optimal_cb_and_depth", "with_overlap"):
        assert n in names
    assert len(exported_names(SRC / "repro" / "io_patterns"
                              / "__init__.py")) == 5


def _lists():
    rng = np.random.default_rng(3)
    cases = []
    for n, cap, order in ((6, 8, "sorted"), (6, 8, "shuffled"),
                          (1, 4, "sorted"), (0, 5, "sorted"),
                          (7, 7, "ties"), (5, 9, "shuffled")):
        offs = np.sort(rng.integers(0, 1000, size=n)).astype(np.int32)
        if order == "shuffled" and n > 1:
            offs = offs[::-1].copy()
        if order == "ties":
            offs[2:4] = offs[2]
        lens = rng.integers(1, 9, size=n).astype(np.int32)
        cases.append((offs, lens, cap))
    return cases


@pytest.mark.parametrize("i", range(len(_lists())))
def test_is_sorted_and_to_numpy_match_the_reference(i):
    offs, lens, cap = _lists()[i]
    j = j_rq.make_requests(jnp.asarray(offs), jnp.asarray(lens), cap)
    t = t_rq.make_requests(offs, lens, cap, device="cpu")
    # garbage past the count: both lists mask it
    t = t._replace(offsets=t.offsets.clone(), lengths=t.lengths.clone())
    assert bool(t_rq.is_sorted(t)) == bool(j_rq.is_sorted(j))
    for a, b in zip(t_rq.to_numpy(t), j_rq.to_numpy(j)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_empty_requests_matches_the_reference():
    t, j = t_rq.empty_requests(5, device="cpu"), j_rq.empty_requests(5)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(t_rq.is_sorted(t))


def test_error_feedback_state_is_a_zero_residual():
    from repro_torch.core import ErrorFeedbackState
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    r = ErrorFeedbackState.init(x)
    assert torch.equal(r, torch.zeros_like(x)) and r.dtype == x.dtype


def reference_serve_flags() -> list[tuple[str, bool]]:
    """``(flag, takes a value)`` of every ``add_argument`` call in the
    reference's serve ``main``."""
    tree = ast.parse((SRC / "repro" / "launch" / "serve.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    flags = []
    for node in ast.walk(main):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            action = kw.get("action")
            store_true = isinstance(action, ast.Constant) \
                and action.value == "store_true"
            flags.append((node.args[0].value, not store_true))
    return flags


def test_the_port_serve_cli_parses_every_reference_flag():
    from repro_torch.launch import serve
    flags = reference_serve_flags()
    assert ("--smoke", False) in flags and len(flags) >= 7
    parser = serve.build_parser()
    for flag, takes_value in flags:
        args = parser.parse_args([flag, "1"] if takes_value else [flag])
        assert hasattr(args, flag.lstrip("-").replace("-", "_")), flag
    assert parser.parse_args([]).smoke is True
