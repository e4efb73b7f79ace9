"""Step builders of the drivers (port of the step half of the
reference's ``launch/steps.py``).

The reference's PartitionSpec and mesh builders (``plan_for_cell``,
``batch_specs``, ``params_specs``, ``opt_state_specs``,
``decode_state_specs``, ``input_specs``) describe XLA sharding for its
dry-run tools; the port runs on one card and has none of them yet.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import optim
from repro_torch._tree import leaves, unflatten
from repro_torch.launch.shapes import ADAFACTOR_ARCHS
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def make_optimizer(arch: str):
    if arch in ADAFACTOR_ARCHS:
        return optim.adafactor()
    return optim.adamw()


def make_train_step(cfg: ModelConfig, opt, lr: float | Callable = 3e-4,
                    remat: bool = True,
                    phase_hook: Callable[[str], None] | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``: the loss and its gradient by autograd (the attention's from
    the backward kernel on the card), then ``opt.update``. ``lr`` is a
    rate or a schedule of the optimizer's step (``optim.warmup_cosine``).
    Functional: new trees come back, the inputs are not changed.
    ``phase_hook``, where given, is called with ``"start"``, then after
    each phase with ``"forward"``, ``"backward"`` and ``"optimizer"``
    (a profiler's marks)."""
    mark = phase_hook or (lambda _: None)

    def train_step(params, opt_state, batch):
        mark("start")
        live = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss = T.loss_fn(unflatten(params, live), cfg, batch, remat=remat)
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


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return T.prefill(params, cfg, batch)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, state, tokens):
        return T.decode_step(params, cfg, state, tokens)
    return serve_step
