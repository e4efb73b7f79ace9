"""The reference's executable checkers, ported (``src/repro/testing/``).

``python -m repro_torch.testing.rounds_checks [--device cpu|cuda]`` and
``python -m repro_torch.testing.spmd_checks [--device cpu|cuda]`` print
one ``PASS <name>`` or ``FAIL <name>`` line a check, under the
reference's check names, then ``<n> failures``, and exit 1 on any
failure. Like every entry point of the port they run on the card unless
``--device cpu`` is given, and raise without one. Every rank is a row
of a tensor on the one device (the rank-axis executor and ``compat``'s
emulated meshes), so no multi-device process is needed. On the card the
I/O kernels run where the reference's checks reach its Pallas kernels
(TAM's sort and coalesce with ``use_kernels=True``, the fused drain and
the zero-skip pair under ``kernel_fusion="fused_round"``, ``pack`` in
the host executor's domain images); on the CPU their plain versions do.
``run(device)`` of either module returns its :class:`Checks` for a
caller in the same process (``chip_smoke.py``).
"""
from __future__ import annotations

import argparse
import sys


class Checks:
    """The named checks of one run, each printed as it is made."""

    def __init__(self, out=None):
        self.out = out
        self.results: list[tuple[str, bool]] = []

    def __call__(self, name: str, ok) -> None:
        ok = bool(ok)
        print(("PASS " if ok else "FAIL ") + name, file=self.out or sys.stdout,
              flush=True)
        self.results.append((name, ok))

    @property
    def failures(self) -> list[str]:
        return [name for name, ok in self.results if not ok]

    @property
    def names(self) -> list[str]:
        return [name for name, _ in self.results]


def cli(run, description: str, argv=None) -> int:
    """The checkers' command line: ``--device`` (default: the card), the
    checks, ``<n> failures``; the exit code is 1 on any failure."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda; raises without a card)")
    args = ap.parse_args(argv)
    checks = run(args.device)
    print(f"{len(checks.failures)} failures", flush=True)
    return 1 if checks.failures else 0
