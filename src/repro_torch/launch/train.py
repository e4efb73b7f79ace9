"""Training driver (port of the reference's ``launch/train.py``).

  --smoke      a reduced config (the reference's ``models.config.reduced``),
               real training; ``--d-model`` / ``--n-layers`` resize it
  (default)    the full config

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi_34b --smoke \
      --steps 200 --ckpt-dir ckpt --io tam --device cpu

Parameters are f32 (the reference trains in f32), from a generator
seeded with 0; matrix products keep torch's default of no TF32, so the
card trains in the f32 the reference trains in. ``--device`` defaults to
``cuda``: attention runs the flash kernel forward and its backward
kernel; ``--device cpu`` runs their plain versions. Checkpoints go
through :class:`~repro_torch.checkpoint.CheckpointManager` on the
reference's writer (8 ranks on 2 nodes, 1 MiB stripes over 4
aggregators). :func:`build_training` builds every object of a run; the
CLI and the card's smoke run share it.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch._tree import leaves
from repro_torch.checkpoint import CheckpointManager, HostCollectiveIO
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, reduced
from repro_torch.optim import warmup_cosine
from repro_torch.runtime import HeartbeatMonitor, TrainLoop, TrainLoopConfig


@dataclass
class Training:
    """Everything a run needs, built by :func:`build_training`."""
    cfg: ModelConfig
    params: Any
    opt: Any
    opt_state: Any
    lr_fn: Callable
    train_step: Callable
    data: SyntheticTokenPipeline
    io: HostCollectiveIO
    ckpt: CheckpointManager
    loop_cfg: TrainLoopConfig

    def loop(self, monitor: HeartbeatMonitor | None = None) -> TrainLoop:
        """A fresh :class:`TrainLoop` over this run's step, data and
        checkpoints."""
        return TrainLoop(self.loop_cfg, self.train_step, self.data,
                         self.ckpt, monitor)


def smoke_config(arch: str, d_model: int | None = None,
                 n_layers: int | None = None) -> ModelConfig:
    """The reference CLI's ``--smoke`` config: ``reduced``, with
    ``--d-model`` / ``--n-layers`` overrides."""
    cfg = configs.get(arch)
    over = {}
    if d_model:
        over.update(d_model=d_model,
                    head_dim=max(d_model // 8, 16), n_heads=8,
                    n_kv_heads=min(4, cfg.n_kv_heads) if cfg.n_kv_heads
                    else 0,
                    d_ff=4 * d_model if cfg.d_ff else 0,
                    vocab=8192)
    if n_layers:
        per = cfg.block_period
        over["n_layers"] = -(-n_layers // per) * per
    return reduced(cfg, **over)


def build_training(arch: str = "yi_34b", *, cfg: ModelConfig | None = None,
                   smoke: bool = False, steps: int = 200, batch: int = 8,
                   seq: int = 64, lr: float = 3e-3,
                   ckpt_dir: str | None = None, ckpt_every: int = 50,
                   io_method: str = "tam", d_model: int | None = None,
                   n_layers: int | None = None, log_every: int = 10,
                   async_checkpoint: bool = False, device=None,
                   phase_hook: Callable[[str], None] | None = None
                   ) -> Training:
    """The reference CLI's objects: the config (``cfg`` overrides
    ``arch``'s, e.g. a full-width config cut in depth), f32 parameters
    seeded 0, ``make_optimizer(arch)`` and its state,
    ``warmup_cosine(lr, warmup=20, total=steps)``, the train step
    (``remat`` off, as the reference CLI's), the synthetic token
    pipeline, the 8-rank writer and the checkpoint manager (``io_method``
    ``"tam"`` or ``"twophase"``), on ``device`` (default the card).
    ``phase_hook`` goes to ``make_train_step``."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = smoke_config(arch, d_model, n_layers) if smoke \
            else configs.get(arch)
    opt = make_optimizer(arch)
    params = T.init_params(0, cfg, dtype=torch.float32, device=dev)
    opt_state = opt.init(params)
    lr_fn = warmup_cosine(lr, warmup=20, total=steps)
    train_step = make_train_step(cfg, opt, lr=lr_fn, remat=False,
                                 phase_hook=phase_hook)
    data = SyntheticTokenPipeline(DataConfig(
        vocab=cfg.vocab, seq=seq, global_batch=batch), device=dev)
    io = HostCollectiveIO(n_ranks=8, n_nodes=2, stripe_size=1 << 20,
                          stripe_count=4, device=dev)
    ckpt = CheckpointManager(
        ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"),
        io, method=io_method)
    loop_cfg = TrainLoopConfig(total_steps=steps, checkpoint_every=ckpt_every,
                               log_every=log_every,
                               async_checkpoint=async_checkpoint)
    return Training(cfg, params, opt, opt_state, lr_fn, train_step, data, io,
                    ckpt, loop_cfg)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi_34b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_ckpt under the temporary "
                         "directory")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--io", default="tam", choices=["tam", "twophase"])
    ap.add_argument("--d-model", type=int, default=None,
                    help="override width (e.g. ~100M-param example)")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    run = build_training(
        args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
        seq=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, io_method=args.io, d_model=args.d_model,
        n_layers=args.n_layers, device=args.device)
    n_params = sum(p.numel() for p in leaves(run.params))
    print(f"arch={run.cfg.name} params={n_params/1e6:.1f}M "
          f"steps={args.steps}")
    loop = run.loop()
    t0 = time.time()
    first_loss = None

    def on_step(step, loss):
        nonlocal first_loss
        if first_loss is None:
            first_loss = loss
        if step % 20 == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"({(time.time()-t0)/step:.2f}s/step)")

    loop.run(run.params, run.opt_state, on_step=on_step)
    last = loop.losses[-1] if loop.losses else float("nan")
    print(f"done: loss {first_loss:.4f} -> {last:.4f} "
          f"in {time.time()-t0:.0f}s")


if __name__ == "__main__":
    main()
