"""The port's mesh paths of the MoE and the decode attention
(``repro_torch.models.moe_sharded``, ``layers.decode_attention_sharded``,
on the rank axes of ``repro_torch.compat``) against the reference's
``shard_map`` bodies, on the CPU.

The reference runs once in an 8-device subprocess (this file as a
script, the ``spmd_env`` fixture) on a (data 2, model 4) mesh and saves
its outputs; the port runs on ``device="cpu"`` with an emulated mesh of
the same shape. Weights are the reference's ``init_moe(PRNGKey(0), cfg,
float32)`` (made again in this process, carried by
``weights.params_from_numpy``); tokens are seeded numpy.

``moe_sharded``: reduced llama4-maverick (top-1) and kimi-k2 (top-2) at
``d_model`` 32, 4 experts (one a model rank), both forms (the
sequence-sharded one on ``[4, 32]`` tokens, the decode one on
``[16, 1]``), at ``capacity_factor`` 4.0 and at the configs' own 1.25,
where ranks drop entries. Exact: each rank's top-k experts and the slot
of every (token, k) entry, the dropped ones included (the same drops).
Within rtol = atol = 2e-3 (``tests/test_torch_moe.py``'s): the output,
the aux loss and the gradients of ``sum(out**2) + aux`` with respect to
every parameter and the tokens, against ``jax.grad`` under
``shard_map``.

The decode form's drop (the reference's ``moe_sharded.py:147-152``: an
entry for another rank's expert takes one of local expert 0's slots with
gate 0): at 32 experts, top-8, 4 tokens and capacity factor 4.0 the
dense path drops nothing, the decode form drops genuine entries, and the
port gives the reference's (non-dense) output.

``decode_attention_sharded``: a [4, 64] cache over 4 model ranks (16
rows a rank), the query at positions in the first and the last shard
and on both sides of a shard boundary; no window and window 8; no
softcap and softcap 20; f32 and bf16. Within 2e-3 (f32) and 1e-2 (bf16:
about one bf16 step) of the reference.
"""
import dataclasses
import subprocess
import sys

import numpy as np
import pytest

D_MODEL = 32
MOE_CASES = [(arch, cf, form) for arch in ("llama4_maverick", "kimi_k2")
             for cf in (4.0, 1.25) for form in ("seq", "decode")]
TOKENS = {"seq": (4, 32), "decode": (16, 1)}       # (batch, seq)
WIDE = dict(num_experts=32, top_k=8, d_ff_expert=32, capacity_factor=4.0)
WIDE_BATCH = 4
ATTN_POS = (5, 15, 16, 60)
ATTN_CASES = [(pos, window, cap, dtype) for pos in ATTN_POS
              for window in (None, 8) for cap in (None, 20.0)
              for dtype in ("float32", "bfloat16")]
B, S, HQ, HKV, HD = 4, 64, 8, 2, 16
GRAD_KEYS = ("router", "wi", "wg", "wo")


def moe_config(configs, reduced, arch, cf):
    """Reduced ``arch`` at ``d_model`` 32 and capacity factor ``cf`` (in
    either package: both configs are the same dataclasses)."""
    cfg = reduced(configs.get(arch))
    return dataclasses.replace(cfg, d_model=D_MODEL, vocab=256,
                               moe=dataclasses.replace(
                                   cfg.moe, capacity_factor=cf))


def wide_config(configs, reduced):
    cfg = reduced(configs.get("kimi_k2"))
    return dataclasses.replace(cfg, d_model=D_MODEL, vocab=256,
                               moe=dataclasses.replace(cfg.moe, **WIDE))


def moe_tokens(i, form):
    """Seeded tokens with a shared offset, which skews the routing so
    that a capacity factor of 1.25 drops entries."""
    rng = np.random.default_rng(100 + i)
    return (rng.normal(size=(*TOKENS[form], D_MODEL)) + 1.0).astype(
        np.float32)


def wide_tokens():
    rng = np.random.default_rng(7)
    return rng.normal(size=(WIDE_BATCH, 1, D_MODEL)).astype(np.float32)


def attn_inputs(dtype):
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for shape in (
        (B, 1, HQ, HD), (B, S, HKV, HD), (B, S, HKV, HD)))
    return q, k, v


def ref_capacity(n_loc, k, e, cf):
    """The reference's ``moe_sharded`` capacity (``:116``)."""
    return max(4, -(-int(n_loc * k / e * cf) // 4) * 4)


def _reference_outputs(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import AxisType
    from jax.sharding import PartitionSpec as P

    from repro import configs
    from repro.compat import shard_map
    from repro.models import layers as JL
    from repro.models import moe_sharded as MS
    from repro.models.config import reduced
    from repro.models.sharding import ShardingPlan, unsharded

    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}

    def route(p, x, cfg, plan):
        """Every rank's top-k experts and entry slots, with the
        reference's own helpers."""
        e, k = cfg.moe.num_experts, cfg.moe.top_k
        seq = plan.shard_seq
        ndp = 2 if plan.data_axes else 1
        b, s, d = x.shape
        n_loc = (b // ndp) * (s // 4 if seq else s)
        cap = ref_capacity(n_loc, k, e, cfg.moe.capacity_factor)
        x_spec = P(plan.dp, "model" if seq else None, None)

        def fn(xl, router):
            xt = xl.reshape(-1, d)
            _, eids, _ = MS._route(xt, router, k)
            if seq:
                _, slot = MS._local_dispatch(xt, eids, e, cap)
            else:
                local = eids - lax.axis_index("model") * (e // 4)
                mine = (local >= 0) & (local < e // 4)
                _, slot = MS._local_dispatch(xt, jnp.where(mine, local, 0),
                                             e // 4, cap)
            return eids[None, None], slot.reshape(eids.shape)[None, None]
        rank_spec = P("data" if plan.data_axes else None, "model")
        eids, slot = jax.jit(shard_map(
            fn, mesh=mesh, in_specs=(x_spec, P(None, None)),
            out_specs=(rank_spec, rank_spec), check_vma=False))(
                x, p["router"])
        return np.asarray(eids), np.asarray(slot), cap

    for i, (arch, cf, form) in enumerate(MOE_CASES):
        cfg = moe_config(configs, reduced, arch, cf)
        p = JL.init_moe(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
        x = jnp.asarray(moe_tokens(i, form))
        plan = ShardingPlan(mesh=mesh, data_axes=("data",),
                            model_axis="model", shard_seq=form == "seq")

        def loss(p, xx, plan=plan, cfg=cfg):
            o, a = JL.moe(p, xx, cfg, plan)
            return jnp.sum(o ** 2) + a
        o, a = jax.jit(lambda p, xx, plan=plan, cfg=cfg: JL.moe(
            p, xx, cfg, plan))(p, x)
        g_p, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
        eids, slot, cap = route(p, x, cfg, plan)
        out.update({f"{i}-out": np.asarray(o), f"{i}-aux": np.asarray(a),
                    f"{i}-eids": eids, f"{i}-slot": slot,
                    f"{i}-cap": np.asarray(cap), f"{i}-gx": np.asarray(g_x),
                    **{f"{i}-g{key}": np.asarray(g_p[key])
                       for key in GRAD_KEYS}})

    cfg = wide_config(configs, reduced)
    p = JL.init_moe(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    x = jnp.asarray(wide_tokens())
    plan = ShardingPlan(mesh=mesh, data_axes=(), model_axis="model",
                        shard_seq=False)
    o, _ = jax.jit(lambda p, xx: JL.moe(p, xx, cfg, plan))(p, x)
    dense, _ = JL.moe(p, x, cfg, unsharded())
    eids, slot, cap = route(p, x, cfg, plan)
    out.update({"wide-out": np.asarray(o), "wide-dense": np.asarray(dense),
                "wide-eids": eids, "wide-slot": slot,
                "wide-cap": np.asarray(cap)})

    plan = ShardingPlan(mesh=mesh, data_axes=("data",), model_axis="model",
                        shard_seq=False)
    for i, (pos, window, cap, dtype) in enumerate(ATTN_CASES):
        q, k, v = (jnp.asarray(t).astype(dtype) for t in attn_inputs(dtype))
        o = jax.jit(lambda q, k, v, pos, window=window, cap=cap:
                    JL.decode_attention_sharded(
                        q, k, v, cache_pos=pos, window=window,
                        logit_cap=cap, plan=plan))(q, k, v, jnp.int32(pos))
        out[f"attn-{i}"] = np.asarray(o.astype(jnp.float32))
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_outputs(sys.argv[1])
    sys.exit(0)


torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.config import reduced as j_reduced  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.compat import EmulatedMesh  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe_sharded as TMS  # noqa: E402
from repro_torch.models.config import reduced as t_reduced  # noqa: E402
from repro_torch.models.sharding import ShardingPlan  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-3)
MESH = EmulatedMesh((2, 4), ("data", "model"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory, spmd_env):
    out = tmp_path_factory.mktemp("jax_moe_sharded") / "reference.npz"
    proc = subprocess.run([sys.executable, __file__, str(out)], env=spmd_env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(out))


def _params(cfg_j):
    p = JL.init_moe(jax.random.PRNGKey(0), cfg_j, dtype=jnp.float32)
    return params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL, **kw)


def _plan(form, data_axes=("data",)):
    return ShardingPlan(mesh=MESH, data_axes=data_axes, model_axis="model",
                        shard_seq=form == "seq")


def _moe_case(i):
    arch, cf, form = MOE_CASES[i]
    cfg_t = moe_config(t_configs, t_reduced, arch, cf)
    cfg_j = moe_config(j_configs, j_reduced, arch, cf)
    return cfg_t, _params(cfg_j), torch.from_numpy(moe_tokens(i, form)), \
        _plan(form)


def _route_vs_reference(route, jax_outputs, key):
    """The port's per-rank routing equals the reference's exactly."""
    want_e, want_s = jax_outputs[f"{key}-eids"], jax_outputs[f"{key}-slot"]
    eids = route.eids.expand(route.slot.shape)
    np.testing.assert_array_equal(eids.reshape(want_e.shape).numpy(), want_e)
    np.testing.assert_array_equal(route.slot.reshape(want_s.shape).numpy(),
                                  want_s)
    assert route.layout.cap == int(jax_outputs[f"{key}-cap"])


MOE_IDS = [f"{a}-cf{cf}-{f}" for a, cf, f in MOE_CASES]


@pytest.mark.parametrize("i", range(len(MOE_CASES)), ids=MOE_IDS)
def test_moe_sharded_routing_and_drops_equal(jax_outputs, i):
    cfg, p, x, plan = _moe_case(i)
    route = TMS.sharded_route(p, x, cfg, plan)
    _route_vs_reference(route, jax_outputs, i)
    if MOE_CASES[i][1] == 4.0 and MOE_CASES[i][2] == "seq":
        assert not bool(route.dropped().any())


def test_the_low_capacity_cases_drop_entries():
    """At capacity factor 1.25 some rank drops a genuine entry in each
    form (the cases above hold those drops equal)."""
    for i, (arch, cf, form) in enumerate(MOE_CASES):
        cfg, p, x, plan = _moe_case(i)
        if cf == 1.25 and arch == "kimi_k2":
            assert bool(TMS.sharded_route(p, x, cfg, plan)
                        .dropped_kept().any()), MOE_CASES[i]


@pytest.mark.parametrize("i", range(len(MOE_CASES)), ids=MOE_IDS)
def test_moe_sharded_out_and_aux(jax_outputs, i):
    cfg, p, x, plan = _moe_case(i)
    out, aux = TL.moe(p, x, cfg, plan=plan)
    assert out.shape == x.shape and aux.shape == ()
    _close(out, jax_outputs[f"{i}-out"])
    _close(aux, jax_outputs[f"{i}-aux"])


@pytest.mark.parametrize("i", range(len(MOE_CASES)), ids=MOE_IDS)
def test_moe_sharded_gradients(jax_outputs, i):
    cfg, p, x, plan = _moe_case(i)
    p = {k: v.requires_grad_() for k, v in p.items()}
    x = x.requires_grad_()
    out, aux = TL.moe(p, x, cfg, plan=plan)
    (out.square().sum() + aux).backward()
    for key in GRAD_KEYS:
        _close(p[key].grad, jax_outputs[f"{i}-g{key}"], err_msg=key)
    _close(x.grad, jax_outputs[f"{i}-gx"])


def test_moe_sharded_wrong_lengths_raise():
    cfg, p, _, _ = _moe_case(0)
    with pytest.raises(ValueError, match="does not divide"):
        TL.moe(p, torch.zeros(4, 30, D_MODEL), cfg, plan=_plan("seq"))
    with pytest.raises(ValueError, match="does not divide"):
        TL.moe(p, torch.zeros(3, 1, D_MODEL), cfg, plan=_plan("decode"))


def test_decode_form_drop_is_the_reference_s(jax_outputs):
    """The decode form's foreign entries take local expert 0's slots:
    genuine entries are dropped where the dense path drops none, and the
    port's output is the reference's, not the dense one."""
    cfg_t = wide_config(t_configs, t_reduced)
    p = _params(wide_config(j_configs, j_reduced))
    x = torch.from_numpy(wide_tokens())
    plan = _plan("decode", data_axes=())
    route = TMS.sharded_route(p, x, cfg_t, plan)
    _route_vs_reference(route, jax_outputs, "wide")
    dense_route = TL.moe_route(p, x.reshape(-1, D_MODEL), cfg_t)
    assert not bool(dense_route.dropped().any())
    lost = route.dropped_kept().any(0)          # over the ranks: [n, k]
    assert bool(lost.any())
    out, _ = TL.moe(p, x, cfg_t, plan=plan)
    dense, _ = TL.moe(p, x, cfg_t)
    _close(dense, jax_outputs["wide-dense"])
    _close(out, jax_outputs["wide-out"])
    # the tokens that lost an entry differ from the dense path, the
    # others equal it
    diff = (out - dense).abs().amax(-1).reshape(-1)
    hit = lost.any(-1)
    assert bool((diff[hit] > 1e-2).all())
    assert bool((diff[~hit] <= 1e-5).all())


ATTN_IDS = [f"pos{p}-w{w}-cap{c}-{d}" for p, w, c, d in ATTN_CASES]


@pytest.mark.parametrize("i", range(len(ATTN_CASES)), ids=ATTN_IDS)
def test_decode_attention_sharded(jax_outputs, i):
    pos, window, cap, dtype = ATTN_CASES[i]
    q, k, v = (torch.from_numpy(t).to(getattr(torch, dtype))
               for t in attn_inputs(dtype))
    got = TL.decode_attention_sharded(q, k, v, cache_pos=pos, window=window,
                                      logit_cap=cap, plan=_plan("decode"))
    assert got.shape == (B, 1, HQ * HD) and got.dtype == q.dtype
    tol = 2e-3 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               jax_outputs[f"attn-{i}"], rtol=tol, atol=tol)


def test_decode_attention_sharded_cache_must_divide():
    q = torch.zeros(B, 1, HQ, HD)
    k = torch.zeros(B, 30, HKV, HD)
    with pytest.raises(ValueError, match="does not divide"):
        TL.decode_attention_sharded(q, k, k, cache_pos=3, window=None,
                                    logit_cap=None, plan=_plan("decode"))
