"""Optimizers over nested dicts of tensors, no library optimizer (port of
``repro.optim.optimizers``).

AdamW keeps bf16 moments (the reference's documented deviation from
fp32-master practice: at 1T params fp32 m/v/master = 14 bytes/param);
Adafactor (factored second moment, no first moment) is the memory-floor
option the reference uses for its >= 400B MoE archs
(``launch.shapes.ADAFACTOR_ARCHS``).

The contract is the reference's ``Optimizer(init, update)``:
``init(params) -> state`` and ``update(grads, state, params, lr) ->
(new_params, new_state)``, functional (new tensors, the inputs
untouched), with ``state["step"]`` an int32 scalar tensor so that a
checkpoint's manifest lists the same leaves in both packages. The math
follows the reference's in f32 (the parameter and moment types are
kept).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch._tree import leaves, tree_map, unflatten


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(tree)))


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]  # (grads, state, params, lr)


def _step0(params) -> torch.Tensor:
    dev = next((p.device for p in leaves(params)), None)
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float | None = 1.0,
          moment_dtype=torch.bfloat16) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": _step0(params)}

    def update(grads, state, params, lr):
        step = state["step"] + 1
        if clip_norm is not None:
            gn = global_norm(grads)
            scale = torch.clamp(clip_norm / torch.clamp(gn, min=1e-9),
                                max=1.0)
            grads = tree_map(lambda g: g * scale.to(g.dtype), grads)
        bc1 = 1.0 - b1 ** step.to(torch.float32)
        bc2 = 1.0 - b2 ** step.to(torch.float32)

        def upd(g, m, v, p):
            g32 = g.float()
            m32 = b1 * m.float() + (1 - b1) * g32
            v32 = b2 * v.float() + (1 - b2) * g32 * g32
            mh, vh = m32 / bc1, v32 / bc2
            delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
            return ((p.float() - lr * delta).to(p.dtype),
                    m32.to(moment_dtype), v32.to(moment_dtype))

        out = [upd(*xs) for xs in zip(leaves(grads), leaves(state["m"]),
                                      leaves(state["v"]), leaves(params))]
        return (unflatten(params, [o[0] for o in out]),
                {"m": unflatten(params, [o[1] for o in out]),
                 "v": unflatten(params, [o[2] for o in out]),
                 "step": step})

    return Optimizer(init=init, update=update)


def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8, weight_decay: float = 0.0) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern, 2018).

    State per matrix param: one row vector + one col vector (fp32);
    scalars/vectors keep a full second moment. No first moment.
    """
    def _factored(p) -> bool:
        return p.ndim >= 2

    def init(params):
        def st(p):
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)}
        return {"f": tree_map(st, params), "step": _step0(params)}

    def update(grads, state, params, lr):
        step = state["step"] + 1
        beta = 1.0 - step.to(torch.float32) ** -decay

        def upd(g, s, p):
            g32 = g.float()
            g2 = g32 * g32 + eps
            if _factored(p):
                vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = (vr[..., None] / torch.clamp(
                    vr.mean(dim=-1, keepdim=True)[..., None], min=eps))
                u = g32 / torch.sqrt(torch.clamp(denom * vc[..., None, :],
                                                 min=eps))
                ns = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g32 / torch.sqrt(torch.clamp(v, min=eps))
                ns = {"v": v}
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            newp = (p.float() - lr * u - lr * weight_decay * p.float())
            return newp.to(p.dtype), ns

        # the factored state of a leaf is a dict: walk the params' leaves
        # and take each leaf's state by the same path
        flat_p = leaves(params)
        flat_s = _state_per_leaf(params, state["f"])
        outs = [upd(g, s, p) for g, s, p in zip(leaves(grads), flat_s,
                                                flat_p)]
        return (unflatten(params, [o[0] for o in outs]),
                {"f": unflatten(params, [o[1] for o in outs]),
                 "step": step})

    return Optimizer(init=init, update=update)


def _state_per_leaf(params, fstate) -> list:
    """The per-leaf state dicts of ``fstate``, in ``params``' leaf order
    (``fstate`` has ``params``' structure with a dict at each leaf)."""
    if isinstance(params, dict):
        return [s for k in sorted(params)
                for s in _state_per_leaf(params[k], fstate[k])]
    if isinstance(params, (list, tuple)):
        return [s for p, f in zip(params, fstate)
                for s in _state_per_leaf(p, f)]
    return [fstate]

