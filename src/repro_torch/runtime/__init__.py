"""Runtime services the host executor uses: failure detection and
elastic replanning (no JAX)."""
from repro_torch.runtime.elastic import ElasticPlan, plan_remesh  # noqa: F401
from repro_torch.runtime.heartbeat import HeartbeatMonitor  # noqa: F401
