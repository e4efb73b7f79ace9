"""The program's own spans and counters.

``span(name)`` marks a step of the program for ``torch.profiler``: while
a profiler records, it is a ``record_function`` annotation, so the step
sits in the trace on the clock of the device events, and the spans open
on the host thread nest as the calls do. With no profiler recording it
is one shared context that does nothing.

``count(name, n)`` adds a host integer to a counter. Counters are always
on; every count is a product of shapes, known on the host, so counting
reads no device value and adds no device work. ``counters()`` and
``reset_counters()`` read and clear them, as ``kernels.launch_counts()``
and ``reset_launch_counts()`` do for the kernels' launches.

Spans, all named ``repro_torch.<step>``: ``write`` / ``read`` (one
collective call), ``exchange`` / ``drain`` (one round of a write),
inside an exchange ``select``, ``route``, ``intranode`` (TAM stage 1),
``bucket`` and ``send``, and a read's ``fetch`` / ``scatter``.
Counters: ``route_slots`` (the element slots that routing walks: rows
times the padded width of each ``repack_sorted``, each bucketing's
element routing and each read scatter), ``route_kernel_slots`` (the
part of ``route_slots`` whose calls copied spans with the
``route_spans`` kernel in place of the per-slot walk: equal to
``route_slots`` where every write routing call ran on the card, 0 on the
CPU and in a read) and ``slow_hop_bytes`` (the bytes of every part sent
across the node axis).
"""
from __future__ import annotations

import contextlib
from collections import Counter

import torch

_NO_SPAN = contextlib.nullcontext()
_counts: Counter = Counter()


def span(name: str):
    """A ``record_function(name)`` while a profiler records, else the
    shared no-op context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def count(name: str, n: int) -> None:
    """Add ``n`` (a host ``int``) to the counter ``name``."""
    _counts[name] += n


def counters() -> dict[str, int]:
    """Every counter's total since the last reset, by name."""
    return dict(_counts)


def reset_counters() -> None:
    _counts.clear()
