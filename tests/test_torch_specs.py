"""The port's input specs and parameter shardings against the
reference's, on the CPU.

For every cell of ``launch.shapes.all_cells()`` on both production
meshes (data 16 x model 16; pod 2 x data 16 x model 16), the port's
``transformer.param_shardings``, ``launch.steps.params_specs`` (shapes
and types on ``meta``), ``opt_state_specs`` (adamw's and adafactor's
trees), ``batch_specs`` and ``decode_state_specs`` equal the reference's
``jax.eval_shape`` results and ``PartitionSpec`` trees leaf for leaf:
the same paths, shapes, types and specs. The reference's
``make_production_mesh`` needs 512 devices, so its side runs once in a
subprocess with ``--xla_force_host_platform_device_count=512`` (as its
``dryrun.py`` does) and hands its trees over as JSON. The port's
``pos`` is an int where the reference's is an int32 scalar.

Also: ``layers.moe_route``'s expert counts (a scatter since ``bincount``
has no meta kernel) equal the reference's at a capacity that drops, and
run on ``meta``; ``init_params`` on ``meta`` draws nothing and gives the
CPU tree's shapes and types.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.config import MoEConfig as JMoE  # noqa: E402
from repro.models.config import reduced as j_reduced  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch._tree import leaves  # noqa: E402
from repro_torch.compat import P  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import shapes as t_shapes  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import MoEConfig as TMoE  # noqa: E402
from repro_torch.models.config import reduced as t_reduced  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = ("single", "multi")
CASES = [(arch, cell.name, mk) for mk in MESHES
         for arch, cell in t_shapes.all_cells()]

REFERENCE = r"""
import json, sys
import jax
from jax.sharding import PartitionSpec
from repro import configs
from repro.launch import shapes as shp
from repro.launch.mesh import make_production_mesh
from repro.launch import steps as S


def key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def flat(shapes, specs):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        out[json.dumps([key(k) for k in path])] = [
            list(leaf.shape), str(leaf.dtype)]
    is_spec = lambda x: isinstance(x, PartitionSpec) or x is None
    for path, sp in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=is_spec)[0]:
        if sp is None:
            continue
        p = json.dumps([key(k) for k in path])
        out.setdefault(p, [None, None]).append(
            [list(e) if isinstance(e, tuple) else e for e in sp])
    return out


result, params, opts = {}, {}, {}
for mk in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=(mk == "multi"))
    for arch, cell in shp.all_cells():
        cfg = configs.get(arch)
        plan = S.plan_for_cell(mesh, cell)
        if arch not in params:
            params[arch] = S.params_specs(cfg, plan)[0]
        p_shapes = params[arch]
        p_specs = S.T.param_shardings(cfg, plan)
        rec = {"params": flat(p_shapes, p_specs)}
        if cell.kind == "train":
            if arch not in opts:
                opts[arch] = jax.eval_shape(S.make_optimizer(arch).init,
                                            p_shapes)
            _, o_specs = S.opt_state_specs(S.make_optimizer(arch), p_shapes,
                                           p_specs)
            rec["opt"] = flat(opts[arch], o_specs)
        if cell.kind in ("train", "prefill"):
            rec["batch"] = flat(*S.batch_specs(cfg, cell, plan))
        rec["decode"] = flat(*S.decode_state_specs(cfg, cell, plan))
        result[f"{arch}|{cell.name}|{mk}"] = rec
json.dump(result, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("specs") / "reference.json"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(SRC)
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


def _key(path):
    return json.dumps(path)


def _flat(shapes, specs) -> dict:
    """``{path: [shape, dtype, spec]}`` of a port tree and its spec tree,
    in the reference side's form (dict keys, list indices, the decode
    state's field names; ``None`` specs left out)."""
    out = {}

    def walk_shapes(node, path):
        if node is None:
            return
        if isinstance(node, torch.Tensor):
            out[_key(path)] = [list(node.shape),
                               str(node.dtype).replace("torch.", "")]
        elif isinstance(node, int):                 # the decode position
            out[_key(path)] = [[], "int32"]
        elif isinstance(node, dict):
            for k, v in node.items():
                walk_shapes(v, path + [k])
        elif hasattr(node, "_fields"):
            for f in node._fields:
                walk_shapes(getattr(node, f), path + [f])
        else:
            for i, v in enumerate(node):
                walk_shapes(v, path + [i])

    def walk_specs(node, path):
        if node is None:
            return
        if isinstance(node, P):
            out.setdefault(_key(path), [None, None]).append(
                [list(e) if isinstance(e, tuple) else e for e in node])
        elif isinstance(node, dict):
            for k, v in node.items():
                walk_specs(v, path + [k])
        elif hasattr(node, "_fields"):
            for f in node._fields:
                walk_specs(getattr(node, f), path + [f])
        else:
            for i, v in enumerate(node):
                walk_specs(v, path + [i])

    walk_shapes(shapes, [])
    walk_specs(specs, [])
    return out


def _port_records(arch, shape_name, mesh_kind) -> dict:
    cfg = t_configs.get(arch)
    cell = t_shapes.shape(shape_name)
    mesh = t_mesh.make_production_mesh(multi_pod=(mesh_kind == "multi"))
    plan = t_steps.plan_for_cell(mesh, cell)
    p_shapes, p_specs = t_steps.params_specs(cfg, plan)
    assert p_specs == TT.param_shardings(cfg, plan)
    rec = {"params": _flat(p_shapes, p_specs)}
    if cell.kind == "train":
        rec["opt"] = _flat(*t_steps.opt_state_specs(
            t_steps.make_optimizer(arch), p_shapes, p_specs))
    if cell.kind in ("train", "prefill"):
        rec["batch"] = _flat(*t_steps.batch_specs(cfg, cell, plan))
    rec["decode"] = _flat(*t_steps.decode_state_specs(cfg, cell, plan))
    for tree in rec.values():
        for shape, _, *spec in tree.values():
            assert shape is not None and len(spec) == 1
    return rec


@pytest.mark.parametrize("arch,shape_name,mesh_kind", CASES,
                         ids=["-".join(c) for c in CASES])
def test_specs_equal_the_reference(reference, arch, shape_name, mesh_kind):
    want = reference[f"{arch}|{shape_name}|{mesh_kind}"]
    got = _port_records(arch, shape_name, mesh_kind)
    assert sorted(got) == sorted(want)
    for group in want:
        assert sorted(got[group]) == sorted(want[group]), group
        for path, leaf in want[group].items():
            assert got[group][path] == leaf, (group, path)


def test_the_spec_trees_are_the_inputs_of_input_specs():
    """``input_specs`` hands the step the trees the spec functions give:
    meta tensors, and spec trees of their structure."""
    cell = t_shapes.shape("train_4k")
    plan = t_steps.plan_for_cell(t_mesh.make_production_mesh(), cell)
    _, args, specs, outs = t_steps.input_specs("kimi_k2", cell, plan)
    assert all(t.device.type == "meta" for t in leaves(args))
    assert set(args[1]) == {"f", "step"}          # adafactor (>= 400B)
    assert outs[0] == specs[0] and outs[2] == P()


def _moe_case(seed=3):
    kw = dict(num_experts=16, top_k=2, d_ff_expert=32, capacity_factor=0.5)
    cfg_j = j_reduced(j_configs.get("kimi_k2"), moe=JMoE(**kw))
    cfg_t = t_reduced(t_configs.get("kimi_k2"), moe=TMoE(**kw))
    p_j = JL.init_moe(jax.random.PRNGKey(seed), cfg_j, dtype=jnp.float32)
    p_t = params_from_numpy(jax.tree.map(np.asarray, p_j), device="cpu")
    x = np.random.default_rng(seed).normal(
        size=(128, cfg_j.d_model)).astype(np.float32)
    return cfg_t, p_j, p_t, x


def test_moe_route_counts_equal_the_reference_at_a_dropping_capacity():
    """The counts ``_moe_dense`` takes the slots' starts from: the
    reference's ``zeros(E).at[flat_e].add(1)`` on its own top-k choices;
    the capacity drops entries."""
    cfg_t, p_j, p_t, x = _moe_case()
    m = cfg_t.moe
    probs = jax.nn.softmax(jnp.asarray(x) @ p_j["router"], axis=-1)
    flat_e = lax.top_k(probs, m.top_k)[1].reshape(-1)
    want = np.asarray(jnp.zeros((m.num_experts,), jnp.int32)
                      .at[flat_e].add(1))
    route = TL.moe_route(p_t, torch.from_numpy(x), cfg_t)
    np.testing.assert_array_equal(route.counts.numpy(), want)
    assert route.counts.dtype == torch.int64
    assert 0 < int(route.dropped().sum()) < route.dropped().numel()
    assert int((~route.ok).sum()) == int(
        np.maximum(want - route.cap, 0).sum())


def test_moe_route_runs_on_meta():
    cfg_t, _, p_t, x = _moe_case()
    p_m = {k: v.to("meta") for k, v in p_t.items()}
    route = TL.moe_route(p_m, torch.from_numpy(x).to("meta"), cfg_t)
    n, k = x.shape[0], cfg_t.moe.top_k
    assert route.counts.device.type == "meta"
    assert route.counts.shape == (cfg_t.moe.num_experts,)
    assert route.slot.shape == (n * k,) and route.eids.shape == (n, k)


@pytest.mark.parametrize("arch", ["gemma2_9b", "jamba_15_large",
                                  "whisper_tiny", "llava_next_34b"])
def test_init_params_on_meta_has_the_cpu_trees_shapes(arch):
    cfg = t_reduced(t_configs.get(arch))
    cpu = TT.init_params(0, cfg, device="cpu")
    meta = TT.init_params(0, cfg, device="meta")
    assert all(t.device.type == "meta" for t in leaves(meta))
    assert [(t.shape, t.dtype) for t in leaves(meta)] == \
        [(t.shape, t.dtype) for t in leaves(cpu)]
    # the seeded values do not depend on the meta path's existence
    again = TT.init_params(0, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(cpu),
                                                 leaves(again)))
