"""Optimizers and learning-rate schedules of the training path (the
port of ``repro.optim``)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adafactor, adamw, global_norm,
)
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
