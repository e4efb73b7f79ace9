"""Puts the repository's root and ``src`` on the path and gives the
tests tiny copies of the benchmark's cells, with the deployment's shape
kept: BT-IO's diagonal multi-partition with uneven cells, a window
smaller than a rank's payload, and many rounds; so that the CPU runs
them in seconds."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench import harness  # noqa: E402

CELLS = ("btio.tam.write", "btio.read")


def tiny_spec(cell: str, traffic: str | None = None) -> harness.Spec:
    """16 ranks (q = 4) over an 18-cubed grid of 5 doubles a point, 15
    rounds of 486 words (a window divides a domain); ``traffic`` in
    place of the cell's own mix, where given."""
    spec = harness.load_spec(ROOT, cell)
    if traffic:
        spec.traffic = json.loads(
            (harness.HERE / "traffic" / f"{traffic}.json").read_text())
    spec.config.update(nodes=4, ranks_per_node=4, grid=18)
    spec.config["io"]["cb_buffer_size"] = 486
    return spec


@pytest.fixture
def tiny():
    return tiny_spec
