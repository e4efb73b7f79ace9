"""Fault-tolerant training loop: checkpoint/restart and heartbeats (port
of ``repro.runtime.trainer``).

Deterministic data pipeline, a train step, rolling TAM checkpoints, and
heartbeat-driven failure handling: on a dead host the loop raises, and
the caller restores from the last committed checkpoint
(``runtime.elastic.find_restart_step``) and runs a new loop from there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.runtime.heartbeat import HeartbeatMonitor


@dataclass
class TrainLoopConfig:
    total_steps: int
    checkpoint_every: int = 50
    log_every: int = 10
    # Overlap the collective write with the following train steps: the
    # checkpoint boundary snapshots to host memory and returns, and the
    # drain runs behind compute (CheckpointManager.save_async); at most
    # one write is in flight.
    async_checkpoint: bool = False


class TrainLoop:
    def __init__(self, cfg: TrainLoopConfig, train_step: Callable,
                 data: SyntheticTokenPipeline,
                 ckpt: CheckpointManager,
                 monitor: HeartbeatMonitor | None = None):
        self.cfg = cfg
        self.train_step = train_step
        self.data = data
        self.ckpt = ckpt
        self.monitor = monitor or HeartbeatMonitor(1, timeout_s=1e9)
        self.losses: list[float] = []

    def run(self, params, opt_state, start_step: int = 0,
            on_step: Callable | None = None):
        """Run to total_steps; returns (params, opt_state, last_step).

        Checks the monitor before every step and raises
        ``RuntimeError("host failure: ...")`` when it reports dead hosts;
        a host failure does NOT drain an in-flight async write (the
        restart finds the latest COMMITTED manifest). Records the loss
        every ``log_every`` steps, saves the state ``{"params", "opt"}``
        every ``checkpoint_every`` steps (``save_async`` with
        ``cfg.async_checkpoint``), and on normal completion blocks on the
        last pending write.
        """
        step = start_step
        while step < self.cfg.total_steps:
            if not self.monitor.healthy():
                raise RuntimeError(
                    f"host failure: {self.monitor.dead_hosts()}")
            batch = self.data.batch_at(step)
            params, opt_state, loss = self.train_step(
                params, opt_state, batch)
            self.monitor.beat(0)
            step += 1
            if step % self.cfg.log_every == 0:
                self.losses.append(float(loss))
            if step % self.cfg.checkpoint_every == 0:
                state = {"params": params, "opt": opt_state}
                if self.cfg.async_checkpoint:
                    self.ckpt.save_async(state, step)
                else:
                    self.ckpt.save(state, step)
            if on_step is not None:
                on_step(step, float(loss))
        if self.cfg.async_checkpoint:
            self.ckpt.block_until_done()
        return params, opt_state, step
