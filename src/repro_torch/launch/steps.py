"""Step functions, the cell's sharding plan, and the input specs of the
dry-run and roofline tools (the port of the reference's
``launch/steps.py``).

``plan_for_cell`` gives a cell its plan on a mesh (``launch.mesh``'s
emulated ones): the step functions thread it into the model, whose MoE
and decode attention then run their rank-axis mesh paths.

The spec functions (``batch_specs``, ``params_specs``,
``opt_state_specs``, ``decode_state_specs``, ``input_specs``) give each
argument of a cell's step as a tensor on ``device="meta"`` (the
reference's ``jax.ShapeDtypeStruct``: shapes and types, zero bytes
allocated) beside its partition spec (``compat.P``, entry for entry the
reference's ``PartitionSpec``). The dry-run traces the step on them
(``launch/dryrun.py``). On a real device the same functions draw real
arguments from a seed, for a cell run on the card.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable

import torch

from repro_torch import configs, optim
from repro_torch._device import resolve_device
from repro_torch._tree import leaves, unflatten
from repro_torch.compat import P
from repro_torch.launch.mesh import make_plan
from repro_torch.launch.shapes import ADAFACTOR_ARCHS, ShapeCell
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import device_of
from repro_torch.models.sharding import ShardingPlan

SEED = 0       # the parameters' seed (the reference's PRNGKey(0))


def plan_for_cell(mesh, cell: ShapeCell,
                  activation_tp: bool | None = None) -> ShardingPlan:
    """The cell's plan: sequence sharding off for decode; the batch
    replicated (no data axes) when the global batch does not divide
    them (long_500k's gb=1). ``activation_tp`` defaults from the
    ``REPRO_ACTIVATION_TP`` environment variable ("1", the default,
    turns it on), as in the reference."""
    if activation_tp is None:
        activation_tp = os.environ.get("REPRO_ACTIVATION_TP", "1") == "1"
    plan = make_plan(mesh, shard_seq=(cell.kind != "decode"))
    plan = dataclasses.replace(plan, activation_tp=activation_tp)
    dp_size = math.prod(mesh.shape[a] for a in plan.data_axes)
    if cell.global_batch % dp_size:
        plan = dataclasses.replace(plan, data_axes=())
    return plan


def make_optimizer(arch: str):
    if arch in ADAFACTOR_ARCHS:
        return optim.adafactor()
    return optim.adamw()


def make_train_step(cfg: ModelConfig, opt, lr: float | Callable = 3e-4,
                    remat: bool = True,
                    phase_hook: Callable[[str], None] | None = None,
                    plan: ShardingPlan | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``: the loss and its gradient by autograd (the attention's from
    the backward kernel on the card), then ``opt.update``. ``lr`` is a
    rate or a schedule of the optimizer's step (``optim.warmup_cosine``).
    Functional: new trees come back, the inputs are not changed.
    ``phase_hook``, where given, is called with ``"start"``, then after
    each phase with ``"forward"``, ``"backward"`` and ``"optimizer"``
    (a profiler's marks). ``plan`` is the model's sharding plan (none:
    one device)."""
    mark = phase_hook or (lambda _: None)

    def train_step(params, opt_state, batch):
        mark("start")
        live = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss = T.loss_fn(unflatten(params, live), cfg, batch, remat=remat,
                         plan=plan)
        mark("forward")
        # a leaf the loss does not read (mamba2's ln2: no MLP follows)
        # gets a zero gradient, as jax.grad gives it
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            live, torch.autograd.grad(loss, live, allow_unused=True))]
        mark("backward")
        rate = lr(opt_state["step"]) if callable(lr) else lr
        with torch.no_grad():
            params, opt_state = opt.update(unflatten(params, grads),
                                           opt_state, params, rate)
        mark("optimizer")
        return params, opt_state, loss.detach()
    return train_step


def make_prefill_step(cfg: ModelConfig, plan: ShardingPlan | None = None):
    def prefill_step(params, batch):
        return T.prefill(params, cfg, batch, plan=plan)
    return prefill_step


def make_decode_step(cfg: ModelConfig, plan: ShardingPlan | None = None):
    def serve_step(params, state, tokens):
        return T.decode_step(params, cfg, state, tokens, plan=plan)
    return serve_step


# ---------------------------------------------------------------------------
# shape/sharding specs
# ---------------------------------------------------------------------------


def _draw(gen: torch.Generator | None, shape, dtype,
          high: int | None = None) -> torch.Tensor:
    """A ``meta`` tensor without a generator; else seeded on the
    generator's device: integers uniform in ``[0, high)``, or standard
    normal values."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    if high is not None:
        return torch.randint(0, high, shape, generator=gen, dtype=dtype,
                             device=gen.device)
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)


def batch_specs(cfg: ModelConfig, cell: ShapeCell, plan: ShardingPlan,
                gen: torch.Generator | None = None):
    """``(shapes, specs)`` of a train or prefill batch: ``tokens`` and
    ``labels`` int32 ``[gb, seq]`` (a vlm's seq less its prefix rows),
    a vlm's ``prefix_embeds`` and an enc-dec's ``frames`` in bf16."""
    gb, s = cell.global_batch, cell.seq
    dp = plan.dp
    tok_s = s - (cfg.num_prefix_embeds if cfg.frontend == "vision" else 0)
    shapes: dict[str, Any] = {
        "tokens": _draw(gen, (gb, tok_s), torch.int32, cfg.vocab),
        "labels": _draw(gen, (gb, tok_s), torch.int32, cfg.vocab),
    }
    specs: dict[str, Any] = {"tokens": P(dp, None), "labels": P(dp, None)}
    if cfg.frontend == "vision":
        shapes["prefix_embeds"] = _draw(
            gen, (gb, cfg.num_prefix_embeds, cfg.d_model), torch.bfloat16)
        specs["prefix_embeds"] = P(dp, None, None)
    if cfg.enc_dec:
        shapes["frames"] = _draw(gen, (gb, cfg.enc_seq, cfg.d_model),
                                 torch.bfloat16)
        specs["frames"] = P(dp, None, None)
    return shapes, specs


def params_specs(cfg: ModelConfig, plan: ShardingPlan, device="meta"):
    """``(shapes, specs)`` of the parameters in bf16: on ``meta`` the
    tree's shapes (nothing drawn), elsewhere ``init_params(SEED)``."""
    return (T.init_params(SEED, cfg, torch.bfloat16, device=device),
            T.param_shardings(cfg, plan))


def spec_map(fn: Callable, specs, *trees):
    """``fn(spec, *leaves)`` over a spec tree (``P`` leaves; ``None`` for
    an absent subtree) and trees of its structure, in its structure."""
    if isinstance(specs, P) or specs is None:
        return fn(specs, *trees)
    if isinstance(specs, dict):
        return {k: spec_map(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    out = [spec_map(fn, v, *(t[i] for t in trees))
           for i, v in enumerate(specs)]
    return type(specs)(*out) if hasattr(specs, "_fields") else \
        type(specs)(out)


def opt_state_specs(opt, params_shapes, params_specs_tree):
    """``(shapes, specs)`` of ``opt.init(params_shapes)``: adamw's
    ``{"m", "v", "step"}`` with the parameters' specs; adafactor's ``{"f":
    {vr, vc} | {v} a leaf, "step"}``, ``vr`` the parameter's spec less its
    last entry and ``vc`` less its second to last."""
    shapes = opt.init(params_shapes)

    def norm(spec, ndim):
        parts = tuple(spec) if spec is not None else ()
        return parts + (None,) * (ndim - len(parts))

    if set(shapes.keys()) == {"m", "v", "step"}:
        return shapes, {"m": params_specs_tree, "v": params_specs_tree,
                        "step": P()}

    def fac_spec(pspec, pshape):
        nd = pshape.ndim
        parts = norm(pspec, nd)
        if nd >= 2:
            return {"vr": P(*parts[:-1]),
                    "vc": P(*(parts[:-2] + parts[-1:]))}
        return {"v": P(*parts)}

    return shapes, {"f": spec_map(fac_spec, params_specs_tree,
                                  params_shapes), "step": P()}


def decode_state_specs(cfg: ModelConfig, cell: ShapeCell,
                       plan: ShardingPlan, gen: torch.Generator | None = None):
    """``(state, specs)`` of a decode cell: bf16 caches for
    ``cell.global_batch`` sequences of ``cell.seq`` positions (an
    enc-dec's ``enc_out`` too), each stacked spec the reference's. The
    reference's ``pos`` is a traced int32 scalar; the port's is an int,
    here ``cell.seq - 1``: one token against a cache full but for that
    slot. With ``gen`` the KV caches, the SSM states and ``enc_out`` are
    seeded normal values on its device."""
    gb, dev = cell.global_batch, device_of(gen)
    enc = (_draw(gen, (gb, cfg.enc_seq, cfg.d_model), torch.bfloat16)
           if cfg.enc_dec else None)
    state = T.init_decode_state(cfg, gb, cell.seq, torch.bfloat16, dev,
                                enc, plan=plan)
    if gen is not None:
        for pair in state.kv + state.ssm:
            for t in pair or ():
                t.normal_(generator=gen)     # in place: caches are large
    kv_specs, ssm_specs = [], []
    for j in range(cfg.block_period):
        if cfg.is_attn_layer(j) and not cfg.attention_free:
            spec = P(None, plan.dp, plan.tp, None, None)
            kv_specs.append((spec, spec))
            ssm_specs.append(None)
        else:
            kv_specs.append(None)
            ssm_specs.append((P(None, plan.dp, plan.tp, None, None),
                              P(None, plan.dp, None, None)))
    specs = T.DecodeState(
        kv=kv_specs, ssm=ssm_specs, pos=P(),
        enc_out=P(plan.dp, None, None) if cfg.enc_dec else None)
    return state._replace(pos=cell.seq - 1), specs


def input_specs(arch: str, cell: ShapeCell, plan: ShardingPlan, *,
                cfg: ModelConfig | None = None, device="meta"):
    """``(step_fn, arg shapes, arg spec trees, out spec trees)`` of a
    cell, as the reference's: ``make_train_step`` (its optimizer,
    ``lr`` 3e-4, remat), ``make_prefill_step`` or ``make_decode_step``
    with ``plan``. The arguments are ``meta`` tensors, or on another
    ``device`` drawn from seeds (parameters ``init_params(SEED)``, the
    batch, tokens and caches from a generator seeded ``SEED + 1``).
    ``cfg`` replaces the arch's config (a cut depth)."""
    cfg = cfg or configs.get(arch)
    dev = resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 1)
    p_shapes, p_specs = params_specs(cfg, plan, dev)
    if cell.kind == "train":
        opt = make_optimizer(arch)
        o_shapes, o_specs = opt_state_specs(opt, p_shapes, p_specs)
        b_shapes, b_specs = batch_specs(cfg, cell, plan, gen)
        fn = make_train_step(cfg, opt, plan=plan)
        return (fn, (p_shapes, o_shapes, b_shapes),
                (p_specs, o_specs, b_specs), (p_specs, o_specs, P()))
    if cell.kind == "prefill":
        b_shapes, b_specs = batch_specs(cfg, cell, plan, gen)
        fn = make_prefill_step(cfg, plan)
        _, st_specs = decode_state_specs(cfg, cell, plan)
        return (fn, (p_shapes, b_shapes), (p_specs, b_specs),
                (P(plan.dp, plan.tp), st_specs))
    if cell.kind == "decode":
        st_shapes, st_specs = decode_state_specs(cfg, cell, plan, gen)
        tok = _draw(gen, (cell.global_batch,), torch.int32, cfg.vocab)
        fn = make_decode_step(cfg, plan)
        return (fn, (p_shapes, st_shapes, tok),
                (p_specs, st_specs, P(plan.dp)),
                (P(plan.dp, plan.tp), st_specs))
    raise ValueError(cell.kind)
