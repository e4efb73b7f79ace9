"""Failure detection (port of ``repro.runtime.heartbeat``).

On a real fleet each host posts a heartbeat to the coordinator (or the
coordinator observes barrier timeouts). Here the monitor abstracts that:
workers call ``beat(host_id)``; the controller polls ``dead_hosts()``.
Failure injection (``inject_failure``) drives the fault-tolerance tests,
the degraded-mode benchmark scenarios, and the checkpoint-restart
example without real hardware deaths.

Recovery semantics (one path): death LATCHES. A host counts as dead the
moment it is injected or the first time a ``dead_hosts()`` poll sees its
heartbeat past ``timeout_s`` — and from then on stays dead regardless of
later beats, until an explicit ``revive(host_id)``. Previously a
timed-out host could silently rejoin via ``beat`` while an injected one
could not; that asymmetry meant a controller could observe a host dead,
re-route its work, and then see it alive again with its work running
twice. ``revive`` is the single, deliberate re-admission point.
"""
from __future__ import annotations

import threading
import time


class HeartbeatMonitor:
    def __init__(self, n_hosts: int, timeout_s: float = 10.0,
                 clock=time.monotonic):
        self.n_hosts = n_hosts
        self.timeout_s = timeout_s
        self._clock = clock
        self._last = {h: clock() for h in range(n_hosts)}
        self._failed: set[int] = set()
        self._lock = threading.Lock()

    def beat(self, host_id: int):
        """Record liveness. A latched-dead host's beats are ignored —
        it must be re-admitted via :meth:`revive`."""
        with self._lock:
            if host_id not in self._failed:
                self._last[host_id] = self._clock()

    def inject_failure(self, host_id: int):
        with self._lock:
            self._failed.add(host_id)

    def revive(self, host_id: int):
        """The ONLY way back from dead — for injected and timed-out
        hosts alike. Clears the latch and refreshes the heartbeat."""
        with self._lock:
            self._failed.discard(host_id)
            self._last[host_id] = self._clock()

    def dead_hosts(self) -> list[int]:
        """Poll for dead hosts; a timed-out host observed here is
        latched into the failed set (it cannot rejoin via ``beat``)."""
        now = self._clock()
        with self._lock:
            for h in range(self.n_hosts):
                if now - self._last[h] > self.timeout_s:
                    self._failed.add(h)
            return sorted(self._failed)

    def healthy(self) -> bool:
        return not self.dead_hosts()
