"""File-domain partitioning (Lustre-style striping).

ROMIO on Lustre selects P_G = stripe_count global aggregators and builds
a one-to-one mapping between aggregators and OSTs: aggregator g owns all
stripes s with ``s % P_G == g``. The two-phase I/O runs in rounds; in
round t aggregator g writes stripe ``t * P_G + g``.

The port's copy of ``repro.core.domains``: the helpers take integer
tensors (or Python ints) and keep their dtype.
"""
from __future__ import annotations

from typing import NamedTuple


class FileLayout(NamedTuple):
    """Striped layout of a file of ``file_len`` elements.

    stripe_size:  elements per stripe.
    stripe_count: number of OSTs == number of global aggregators P_G.
    file_len:     total elements (padded to a stripe multiple by callers
                  that need an exact partition).
    """

    stripe_size: int
    stripe_count: int
    file_len: int

    @property
    def num_stripes(self) -> int:
        return -(-self.file_len // self.stripe_size)

    @property
    def num_rounds(self) -> int:
        """Rounds of two-phase I/O (each aggregator writes one stripe/round)."""
        return -(-self.num_stripes // self.stripe_count)

    @property
    def domain_len(self) -> int:
        """Elements owned by one aggregator (its file domain), padded."""
        return self.num_rounds * self.stripe_size


def owner_of(layout: FileLayout, offsets):
    """Global aggregator owning each (stripe-split) request offset."""
    return (offsets // layout.stripe_size) % layout.stripe_count


def round_of(layout: FileLayout, offsets):
    """Two-phase round in which each offset is written."""
    return (offsets // layout.stripe_size) // layout.stripe_count


def to_domain_local(layout: FileLayout, offsets):
    """Map file offsets to positions inside the owner's file domain:
    ``round(o) * stripe_size + (o % stripe_size)``."""
    within = offsets % layout.stripe_size
    return round_of(layout, offsets) * layout.stripe_size + within


def from_domain_local(layout: FileLayout, agg: int, local):
    """Inverse of :func:`to_domain_local` for aggregator ``agg``."""
    rnd = local // layout.stripe_size
    within = local % layout.stripe_size
    return (rnd * layout.stripe_count + agg) * layout.stripe_size + within


def contiguous_layout(file_len: int, num_aggregators: int) -> FileLayout:
    """Non-striped fallback: one contiguous domain per aggregator
    (a stripe size of ceil(file_len / P_G))."""
    stripe = -(-file_len // num_aggregators)
    return FileLayout(stripe_size=stripe, stripe_count=num_aggregators,
                      file_len=file_len)
