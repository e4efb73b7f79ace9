"""Executor-transport registry (the ``IOConfig.transport`` knob).

The port's copy of the registry half of the reference's
``repro.core.transport``: the planner pass ``passes.resolve_transport``
validates the knob here, so an unregistered name dies at plan time. The
socket framing of the multi-process executor is not ported yet.
"""
from __future__ import annotations

#: legal non-None values of the ``transport`` knob. ``None`` means the
#: in-process executor — no real transport.
TRANSPORTS: tuple[str, ...] = ("mp",)


def resolve_transport(name):
    """Validate a requested transport name (the planner-pass hook).

    ``None`` (in-process executors) passes through; anything else must
    be registered in :data:`TRANSPORTS`.
    """
    if name is not None and name not in TRANSPORTS:
        raise ValueError(
            f"unknown transport {name!r}; known: {(None,) + TRANSPORTS}")
    return name
