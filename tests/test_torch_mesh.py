"""The port's sharding plans and its mesh'd model against the
reference's, on the CPU.

``ShardingPlan`` (``repro_torch.models.sharding``): every spec method
equals the reference's ``PartitionSpec`` entry for entry, single-pod and
multi-pod, with ``shard_seq`` and ``activation_tp`` on and off, and
without data axes. ``plan_for_cell`` on ``make_production_mesh()``
equals the reference's on a mesh of the same shape for every cell (the
data axes drop at batch 1; ``REPRO_ACTIVATION_TP`` is read).

The mesh'd model: the reference runs once in an 8-device subprocess
(this file as a script, the ``spmd_env`` fixture) on a (data 2, model 4)
mesh with Auto axes (with JAX 0.9's default Explicit axes the
reference's ``with_sharding_constraint`` raises), the port on an
emulated mesh of that shape. Configs: reduced kimi-k2 (moe, at its own
capacity factor 1.25), jamba-1.5-large (hybrid: attention,
Mamba2, MoE and MLP layers), gemma2-9b (window cut to 6, softcaps) and
whisper-tiny (enc-dec: the decoder's self-attention sharded at decode).
Weights are the reference's ``init_params(PRNGKey(0), cfg, float32)``
(made again in this process, carried by ``weights.params_from_numpy``);
tokens and frames are seeded numpy. At rtol = atol = 2e-3 (the repo's
model tolerance): ``forward``'s logits and aux, ``loss_fn`` and every
gradient leaf against ``jax.grad`` (the plan with sequence sharding),
``prefill``'s logits and caches, three teacher-forced ``decode_step``s
under the decode plan (sequence sharding off) and their caches. The MoE
layers' drops in the forward: each rank's slot of every (token, k)
entry equals the reference's, from the reference's own routing helpers
on its layer inputs (at 4 tokens a rank nothing is dropped here: the
capacity is at least 4; ``test_torch_moe_sharded.py`` holds drops).

The inputs are those the unsharded model tests use. At other seeds the
unsharded port itself can miss 2e-3 against the reference (ROADMAP queue
3): a one-ulp f32 difference (XLA's rms_norm against PyTorch's) can flip
a bf16 rounding of the probabilities or values in the reference's
attention, which the port reproduces.
"""
import dataclasses
import subprocess
import sys

import numpy as np
import pytest

ARCHS = ("kimi_k2", "jamba_15_large", "gemma2_9b", "whisper_tiny")
B, S, PRE = 2, 16, 8          # batch, tokens, prefill length
N_DEC = 3
MESH_SHAPE = ((2, 4), ("data", "model"))


def model_config(configs, reduced, arch):
    """The reduced ``arch`` of either package (the same dataclasses)."""
    cfg = reduced(configs.get(arch))
    if arch == "kimi_k2":     # the config's own capacity factor
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.25))
    if arch == "gemma2_9b":
        cfg = dataclasses.replace(cfg, window=6)
    return cfg


def model_inputs(cfg):
    """The inputs the unsharded model tests (``test_torch_families.py``,
    ``test_torch_vlm_audio.py``) hold the port to: tokens and labels from
    ``default_rng(1)``, then an enc-dec's unit-normal frames."""
    rng = np.random.default_rng(1)
    tokens, labels = (rng.integers(0, cfg.vocab, size=(B, S)).astype(
        np.int32) for _ in range(2))
    frames = (rng.normal(0, 1, (B, cfg.enc_seq, cfg.d_model)).astype(
        np.float32) if cfg.enc_dec else None)
    return tokens, labels, frames


def moe_capacity(n_loc, k, e, cf):
    return max(4, -(-int(n_loc * k / e * cf) // 4) * 4)


def _reference_outputs(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from jax.sharding import PartitionSpec as P

    from repro import configs
    from repro.compat import shard_map
    from repro.launch import serve
    from repro.models import layers as JL
    from repro.models import moe_sharded as MS
    from repro.models import transformer as JT
    from repro.models.config import reduced
    from repro.models.sharding import ShardingPlan

    mesh = jax.make_mesh(*MESH_SHAPE, axis_types=(AxisType.Auto,) * 2)
    plan = ShardingPlan(mesh=mesh, data_axes=("data",), model_axis="model",
                        shard_seq=True)
    plan_d = dataclasses.replace(plan, shard_seq=False)
    out = {}
    for arch in ARCHS:
        cfg = model_config(configs, reduced, arch)
        params = JT.init_params(jax.random.PRNGKey(0), cfg,
                                dtype=jnp.float32)
        tokens, labels, frames = model_inputs(cfg)
        batch = {"tokens": jnp.asarray(tokens),
                 "labels": jnp.asarray(labels)}
        if frames is not None:
            batch["frames"] = jnp.asarray(frames)
        logits, aux = jax.jit(lambda p, b: JT.forward(p, cfg, b, plan))(
            params, batch)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: JT.loss_fn(p, cfg, b, plan)))(params, batch)
        out.update({f"{arch}-logits": np.asarray(logits),
                    f"{arch}-aux": np.asarray(aux),
                    f"{arch}-loss": np.asarray(loss)})
        for j, g in enumerate(jax.tree.leaves(grads)):
            out[f"{arch}-grad{j}"] = np.asarray(g)

        pre = {k: v[:, :PRE] if k != "frames" else v
               for k, v in batch.items() if k != "labels"}
        last, state = jax.jit(lambda p, b: JT.prefill(p, cfg, b, plan))(
            params, pre)
        out[f"{arch}-prefill"] = np.asarray(last)
        state = serve._grow_caches(state, S - PRE)
        dec = jax.jit(lambda p, s, t: JT.decode_step(p, cfg, s, t, plan_d))
        for t in range(PRE, PRE + N_DEC):
            lg, state = dec(params, state, jnp.asarray(tokens[:, t]))
            out[f"{arch}-decode{t}"] = np.asarray(lg)
        for j, c in enumerate(jax.tree.leaves((state.kv, state.ssm))):
            out[f"{arch}-cache{j}"] = np.asarray(c)

        if cfg.moe is None:
            continue
        # the MoE layers' inputs in the mesh'd forward, then each rank's
        # entry slots from the reference's own helpers
        seen = []
        moe = JL.moe

        def recording(p, x, cfg_, plan_):
            # each layer's input depends on the one before: they come in
            # layer order
            jax.debug.callback(lambda v: seen.append(np.asarray(v)), x)
            return moe(p, x, cfg_, plan_)
        JL.moe = recording
        try:
            jax.block_until_ready(jax.jit(
                lambda p, b: JT.forward(p, cfg, b, plan))(params, batch))
        finally:
            JL.moe = moe
        e, k = cfg.moe.num_experts, cfg.moe.top_k
        cap = moe_capacity(S // 4, k, e, cfg.moe.capacity_factor)

        def slots(xl, router):
            xt = xl.reshape(-1, cfg.d_model)
            _, eids, _ = MS._route(xt, router, k)
            _, slot = MS._local_dispatch(xt, eids, e, cap)
            return slot.reshape(eids.shape)[None, None]
        route = jax.jit(shard_map(
            slots, mesh=mesh, in_specs=(P("data", "model", None),
                                        P(None, None)),
            out_specs=P("data", "model"), check_vma=False))
        moe_layers = [(j, bi) for bi in range(
            cfg.n_layers // cfg.block_period)
            for j in range(cfg.block_period) if cfg.is_moe_layer(j)]
        assert len(seen) == len(moe_layers), (len(seen), moe_layers)
        for n, ((j, bi), x) in enumerate(zip(moe_layers, seen)):
            router = params["blocks"]["slots"][j]["moe"]["router"][bi]
            out[f"{arch}-moe_x{n}"] = x
            out[f"{arch}-slots{n}"] = np.asarray(route(x, router))
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_outputs(sys.argv[1])
    sys.exit(0)


torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.launch import shapes as j_shapes  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import sharding as j_sharding  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import reduced as j_reduced  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch._tree import (leaves, leaves_with_paths,  # noqa: E402
                               unflatten)
from repro_torch.compat import EmulatedMesh  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import shapes as t_shapes  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe_sharded as TMS  # noqa: E402
from repro_torch.models import sharding as t_sharding  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import reduced as t_reduced  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-3)
SPEC_METHODS = ("embed", "attn_qkv", "attn_o", "mlp_in", "mlp_out",
                "moe_in", "moe_out", "vector", "act", "act_heads", "kv_full",
                "act_ff", "logits", "tokens", "kv_cache", "ssm_state",
                "moe_dispatch", "flat_tokens", "flat_tokens_1d")
PLAN_CASES = [(data_axes, seq, atp)
              for data_axes in (("data",), ("pod", "data"), ())
              for seq in (True, False) for atp in (True, False)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _entries(spec):
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


@pytest.mark.parametrize("data_axes,seq,atp", PLAN_CASES,
                         ids=[f"{'+'.join(d) or 'nodata'}-seq{int(s)}-atp"
                              f"{int(a)}" for d, s, a in PLAN_CASES])
def test_plan_specs_equal_the_reference(data_axes, seq, atp):
    kw = dict(data_axes=data_axes, model_axis="model", shard_seq=seq,
              activation_tp=atp)
    pj = j_sharding.ShardingPlan(mesh=None, **kw)
    pt = t_sharding.ShardingPlan(mesh=None, **kw)
    assert pt.dp == pj.dp and pt.tp == pj.tp
    for name in SPEC_METHODS:
        assert _entries(getattr(pt, name)()) == _entries(
            getattr(pj, name)()), name
    x = torch.ones(2, 3)
    assert pt.constrain(x, pt.act()) is x


def test_unsharded_plan_has_no_mesh():
    assert t_sharding.unsharded().mesh is None
    assert t_sharding.unsharded() == t_sharding.ShardingPlan()


@pytest.mark.parametrize("multi_pod", (False, True))
def test_production_mesh_and_plan(multi_pod):
    m = t_mesh.make_production_mesh(multi_pod=multi_pod)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    assert m.axis_names == names and tuple(m.shape.values()) == shape
    assert m.size == int(np.prod(shape))
    plan = t_mesh.make_plan(m)
    assert plan.data_axes == names[:-1] and plan.model_axis == "model"
    io = t_mesh.make_io_mesh(2, 2, 4)
    assert io.shape == {"node": 2, "lagg": 2, "lmem": 4} and io.size == 16


@pytest.mark.parametrize("multi_pod", (False, True))
@pytest.mark.parametrize("atp_env", (None, "0"))
@pytest.mark.parametrize("cell", [c.name for c in t_shapes.SHAPES])
def test_plan_for_cell_equals_the_reference(monkeypatch, cell, atp_env,
                                            multi_pod):
    if atp_env is None:
        monkeypatch.delenv("REPRO_ACTIVATION_TP", raising=False)
    else:
        monkeypatch.setenv("REPRO_ACTIVATION_TP", atp_env)
    m_t = t_mesh.make_production_mesh(multi_pod=multi_pod)
    m_j = AbstractMesh(tuple(m_t.shape.values()), m_t.axis_names)
    pt = t_steps.plan_for_cell(m_t, t_shapes.shape(cell))
    pj = j_steps.plan_for_cell(m_j, j_shapes.shape(cell))
    for f in ("data_axes", "model_axis", "shard_seq", "activation_tp"):
        assert getattr(pt, f) == getattr(pj, f), f
    assert pt.mesh is m_t


def test_plan_for_cell_drops_the_data_axes_at_batch_1():
    m = t_mesh.make_production_mesh()
    one = t_shapes.ShapeCell("b1", "decode", 8208, 1)
    four = t_shapes.ShapeCell("b4", "prefill", 32, 4)
    assert t_steps.plan_for_cell(m, one).data_axes == ()
    assert t_steps.plan_for_cell(m, four).data_axes == ()
    assert t_steps.plan_for_cell(m, t_shapes.ShapeCell(
        "b32", "prefill", 32, 32)).data_axes == ("data",)
    assert not t_steps.plan_for_cell(m, one).shard_seq


# ---------------------------------------------------------------------------
# the mesh'd model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory, spmd_env):
    out = tmp_path_factory.mktemp("jax_mesh") / "reference.npz"
    proc = subprocess.run([sys.executable, __file__, str(out)], env=spmd_env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(out))


MESH = EmulatedMesh(*MESH_SHAPE)
PLAN = t_sharding.ShardingPlan(mesh=MESH, data_axes=("data",),
                               model_axis="model", shard_seq=True)
PLAN_D = dataclasses.replace(PLAN, shard_seq=False)


MOE_ARCHS = tuple(a for a in ARCHS
                  if model_config(t_configs, t_reduced, a).moe is not None)
_MODELS = {}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param)


def _model(arch):
    """(arch, port config, the reference's f32 params on the port, the
    batch), made once a module."""
    if arch not in _MODELS:
        _MODELS[arch] = _make_model(arch)
    return _MODELS[arch]


def _make_model(arch):
    cfg_j = model_config(j_configs, j_reduced, arch)
    cfg_t = model_config(t_configs, t_reduced, arch)
    params_j = JT.init_params(jax.random.PRNGKey(0), cfg_j,
                              dtype=jnp.float32)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    tokens, labels, frames = model_inputs(cfg_t)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    if frames is not None:
        batch["frames"] = torch.from_numpy(frames)
    return arch, cfg_t, params_t, batch


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want), **TOL, **kw)


def test_mesh_forward(jax_outputs, model):
    arch, cfg, params, batch = model
    logits, aux = TT.forward(params, cfg, batch, plan=PLAN)
    _close(logits, jax_outputs[f"{arch}-logits"])
    _close(aux, jax_outputs[f"{arch}-aux"])


def test_mesh_loss_and_gradients(jax_outputs, model):
    arch, cfg, params, batch = model
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss = TT.loss_fn(unflatten(params, live), cfg, batch, plan=PLAN)
    _close(loss, jax_outputs[f"{arch}-loss"])
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    paths = [p for p, _ in leaves_with_paths(params)]
    assert len(grads) == len([k for k in jax_outputs
                              if k.startswith(f"{arch}-grad")])
    for j, (path, g) in enumerate(zip(paths, grads)):
        want = jax_outputs[f"{arch}-grad{j}"]
        if g is None:           # a leaf the loss does not read
            assert not np.any(want), path
            continue
        _close(g, want, err_msg=path)


def test_mesh_train_step_builder_threads_the_plan(model):
    """``make_train_step(plan=)`` takes the loss of the mesh'd model."""
    arch, cfg, params, batch = model
    from repro_torch import optim
    step = t_steps.make_train_step(cfg, optim.adamw(), remat=False,
                                   plan=PLAN)
    _, _, loss = step(params, optim.adamw().init(params), batch)
    want = TT.loss_fn(params, cfg, batch, plan=PLAN)
    assert torch.equal(loss, want.detach())


def test_mesh_prefill_and_decode(jax_outputs, model):
    arch, cfg, params, batch = model
    pre = {k: v[:, :PRE] if k != "frames" else v
           for k, v in batch.items() if k != "labels"}
    prefill = t_steps.make_prefill_step(cfg, PLAN)
    decode = t_steps.make_decode_step(cfg, PLAN_D)
    last, state = prefill(params, pre)
    _close(last, jax_outputs[f"{arch}-prefill"])
    state = t_serve._grow_caches(state, S - PRE)
    for t in range(PRE, PRE + N_DEC):
        logits, state = decode(params, state, batch["tokens"][:, t])
        _close(logits, jax_outputs[f"{arch}-decode{t}"], err_msg=str(t))
    caches = [c for pair in (*state.kv, *state.ssm) if pair is not None
              for c in pair]
    kv = [c for pair in state.kv if pair is not None for c in pair]
    ssm = [c for pair in state.ssm if pair is not None for c in pair]
    assert len(caches) == len(kv) + len(ssm)
    for j, c in enumerate(kv + ssm):
        _close(c, jax_outputs[f"{arch}-cache{j}"], err_msg=f"cache {j}")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_mesh_moe_drops_equal_the_reference(jax_outputs, arch):
    arch, cfg, params, batch = _model(arch)
    seen = []
    moe = TL.moe

    def recording(p, x, cfg_, plan=None):
        seen.append(TMS.sharded_route(p, x, cfg_, plan))
        return moe(p, x, cfg_, plan=plan)
    TL.moe = recording
    try:
        TT.forward(params, cfg, batch, plan=PLAN)
    finally:
        TL.moe = moe
    n_layers = len([k for k in jax_outputs if k.startswith(f"{arch}-slots")])
    assert len(seen) == n_layers > 0
    for n, route in enumerate(seen):
        want = jax_outputs[f"{arch}-slots{n}"]
        np.testing.assert_array_equal(route.slot.reshape(want.shape).numpy(),
                                      want, err_msg=f"moe layer {n}")


def test_the_mesh_modules_load_neither_jax_nor_repro():
    code = ("import sys, repro_torch.compat, repro_torch.launch.mesh, "
            "repro_torch.models.sharding, repro_torch.core.hierarchical, "
            "repro_torch.models.moe_sharded, repro_torch.models.pipeline, "
            "repro_torch.launch.steps; print([m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'repro')])")
    import os
    from pathlib import Path
    env = dict(os.environ,
               PYTHONPATH=str(Path(__file__).resolve().parent.parent / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
