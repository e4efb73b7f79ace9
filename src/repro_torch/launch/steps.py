"""Step builders of the drivers and the cell's sharding plan (port of
the step half of the reference's ``launch/steps.py``).

``plan_for_cell`` gives a cell its plan on a mesh (``launch.mesh``'s
emulated ones): the step builders thread it into the model, whose MoE
and decode attention then run their rank-axis mesh paths. The
reference's spec builders (``batch_specs``, ``params_specs``,
``opt_state_specs``, ``decode_state_specs``, ``input_specs``) describe
XLA sharding for its dry-run tools; the port has none of them yet.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable

import torch

from repro_torch import optim
from repro_torch._tree import leaves, unflatten
from repro_torch.launch.mesh import make_plan
from repro_torch.launch.shapes import ADAFACTOR_ARCHS, ShapeCell
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import ShardingPlan


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
