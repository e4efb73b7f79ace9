"""Runtime services: failure detection, elastic replanning, restart
discovery and the fault-tolerant training loop (no JAX)."""
from repro_torch.runtime.elastic import (  # noqa: F401
    ElasticPlan, find_restart_step, plan_remesh,
)
from repro_torch.runtime.heartbeat import HeartbeatMonitor  # noqa: F401
from repro_torch.runtime.trainer import TrainLoop, TrainLoopConfig  # noqa: F401
