"""Deterministic, host-sharded synthetic token pipeline (port of
``repro.data.pipeline``).

Each host produces only its shard of the global batch (by host id),
deterministically from (seed, step): a restart at step N regenerates
exactly the batch stream from N without data-state checkpointing. The
tokens come from the reference's numpy stream, array for array; the
batches are int32 tensors on the pipeline's device (the card unless the
caller asks for the CPU).

Straggler mitigation: the iterator prefetches ahead with a bounded-wait
deadline; a host that misses the deadline serves the (deterministic)
fallback batch computed synchronously.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch._device import resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq: int
    global_batch: int
    num_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    prefetch: int = 2
    deadline_s: float = 30.0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


class SyntheticTokenPipeline:
    """Markov-ish synthetic LM tokens (deterministic per (seed, step)),
    as tensors on ``device``."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def numpy_batch_at(self, step: int) -> dict:
        """The reference's batch: ``tokens`` and ``labels`` int32 arrays
        ``[host_batch, seq]``."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
        # zipf-flavored unigram + local repetition, enough structure for a
        # loss to fall during the example runs
        base = rng.zipf(1.3, size=(cfg.host_batch, cfg.seq + 1))
        tokens = (base % (cfg.vocab - 2)) + 1
        rep = rng.random((cfg.host_batch, cfg.seq + 1)) < 0.3
        tokens = np.where(rep, np.roll(tokens, 1, axis=1), tokens)
        tokens = tokens.astype(np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def to_device(self, batch: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for k, a in batch.items()}

    def batch_at(self, step: int) -> dict:
        return self.to_device(self.numpy_batch_at(step))


def make_batch_iterator(cfg: DataConfig, start_step: int = 0, device=None
                        ) -> Iterator[dict]:
    """Prefetching iterator with bounded-wait straggler fallback (numpy
    batches are made ahead on a thread; each is moved to ``device`` as it
    is served)."""
    pipe = SyntheticTokenPipeline(cfg, device)
    q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set():
            try:
                q.put((step, pipe.numpy_batch_at(step)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    step = start_step
    try:
        while True:
            try:
                got_step, batch = q.get(timeout=cfg.deadline_s)
                # deterministic stream: producer and consumer agree on
                # step order; a lagging producer is simply skipped past
                while got_step < step:
                    got_step, batch = q.get(timeout=cfg.deadline_s)
            except queue.Empty:
                batch = pipe.numpy_batch_at(step)  # bounded-wait fallback
            yield pipe.to_device(batch)
            step += 1
    finally:
        stop.set()
