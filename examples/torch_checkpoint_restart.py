"""Fault tolerance demo of the PyTorch port: kill-and-recover with an
elastic re-mesh.

1. Train a small model, checkpointing through TAM every 20 steps.
2. Inject a host failure at step 47 (the heartbeat monitor fires).
3. Restore the latest checkpoint (step 40) and finish the run: the
   checkpoint's byte space is mesh-agnostic and the deterministic data
   pipeline replays the exact batch stream.
4. Verify that the recovered run reaches the loss of an uninterrupted
   control run.

The twin of ``examples/checkpoint_restart.py``, through ``repro_torch``.
Checkpoints go to a temporary directory, removed at the end.

Run:  PYTHONPATH=src python examples/torch_checkpoint_restart.py \\
          [--device cpu]
(the default device is the card).
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    HostCollectiveIO)
from repro_torch.data import DataConfig, SyntheticTokenPipeline  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import (HeartbeatMonitor, TrainLoop,  # noqa: E402
                                 TrainLoopConfig, plan_remesh)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced(configs.get("glm4_9b"))
    opt = adamw(weight_decay=0.0)
    data = SyntheticTokenPipeline(DataConfig(vocab=cfg.vocab, seq=32,
                                             global_batch=4), device=dev)
    train_step = make_train_step(cfg, opt, lr=1e-3, remat=False)
    io = HostCollectiveIO(n_ranks=8, n_nodes=2, stripe_size=1 << 16,
                          stripe_count=4, device=dev)
    params = T.init_params(0, cfg, dtype=torch.float32, device=dev)
    opt_state = opt.init(params)

    # ---- control: uninterrupted 80 steps ---------------------------------
    ctrl_p, ctrl_o = params, opt_state
    for step in range(80):
        ctrl_p, ctrl_o, ctrl_loss = train_step(ctrl_p, ctrl_o,
                                               data.batch_at(step))
    print(f"control final loss: {float(ctrl_loss):.5f}")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        # ---- faulty run ---------------------------------------------------
        mon = HeartbeatMonitor(n_hosts=4, timeout_s=1e9)
        ckpt = CheckpointManager(ckpt_dir, io, method="tam",
                                 local_aggregators=4)
        loop = TrainLoop(TrainLoopConfig(total_steps=80,
                                         checkpoint_every=20),
                         train_step, data, ckpt, monitor=mon)

        def inject(step, loss):
            if step == 47:
                mon.inject_failure(2)

        try:
            loop.run(params, opt_state, on_step=inject)
            raise AssertionError("failure was not detected")
        except RuntimeError as e:
            print(f"detected: {e} at latest checkpoint step "
                  f"{ckpt.latest_step()}")

        # ---- recovery: re-mesh for 3 surviving hosts and resume -----------
        plan = plan_remesh(total_devices=3 * 4, model_parallel=4,
                           old_data_parallel=4)
        print(f"elastic plan: mesh {plan.mesh_shape}, "
              f"grad_accum x{plan.grad_accum}")
        mon.revive(2)

        state, step0 = ckpt.restore({"params": params, "opt": opt_state})
        params2, opt2 = state["params"], state["opt"]
        loop2 = TrainLoop(TrainLoopConfig(total_steps=80,
                                          checkpoint_every=20),
                          train_step, data, ckpt, monitor=mon)
        params2, opt2, _ = loop2.run(params2, opt2, start_step=step0)

    with torch.no_grad():
        final = float(T.loss_fn(params2, cfg, data.batch_at(80)))
        ctrl_final = float(T.loss_fn(ctrl_p, cfg, data.batch_at(80)))
    print(f"recovered loss {final:.5f} vs control {ctrl_final:.5f}")
    if abs(final - ctrl_final) >= 0.05:
        print("recovery diverged")
        return 1
    print("OK: kill-and-recover run matches uninterrupted control")
    return 0


if __name__ == "__main__":
    sys.exit(main())
