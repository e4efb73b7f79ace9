"""Elastic re-meshing after node loss, and restart discovery (port of
``repro.runtime.elastic``).

Policy: keep the model axis intact (TP/EP shards are load-bearing —
losing one breaks every layer) and shrink the DATA axis to the largest
size the surviving hosts support; the global batch is preserved by
raising per-replica accumulation. ``core.faults.apply_resize`` replans
a host writer through :func:`plan_remesh`.

The port has no device mesh (every rank is a row of one tensor on one
card), so :class:`ElasticPlan` carries the shape only.

Restart discovery (:func:`find_restart_step`) is the other half of a
kill-and-resume: it trusts only COMMITTED checkpoints. The save path
writes the manifest last (``checkpoint._commit_write``), so a process
killed mid-drain leaves segment files with no manifest — invisible
here — and a drain torn mid-segment leaves ``.partial`` markers
(``core.faults.partial_marker``) that disqualify the step.
"""
from __future__ import annotations

import json
import warnings
from dataclasses import dataclass
from pathlib import Path

from repro_torch.core.faults import partial_marker


@dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    grad_accum: int        # microbatch multiplier preserving global batch
    #: survivors stranded by rounding the data axis down to a power of
    #: two — they sit idle until the next resize; never silently zero'd
    unused_devices: int = 0


def plan_remesh(total_devices: int, model_parallel: int,
                old_data_parallel: int, *,
                pods: int = 1) -> ElasticPlan:
    """Largest power-of-two data axis that fits the surviving devices.

    Rounding down can strand survivors (e.g. 24 hosts -> data axis 16,
    8 hosts idle). The plan reports the stranded count as
    ``unused_devices`` and warns, so the controller can choose to fold
    them back in (spares, eval, a later grow event) instead of the
    capacity silently vanishing.
    """
    if total_devices < model_parallel:
        raise ValueError(
            f"cannot keep model axis: {total_devices} devices < "
            f"TP {model_parallel}")
    pods = max(pods, 1)
    avail = total_devices // model_parallel // pods
    data = 1
    while data * 2 <= avail:
        data *= 2
    accum = max(1, old_data_parallel // data)
    unused = total_devices - data * model_parallel * pods
    if unused > 0:
        warnings.warn(
            f"plan_remesh strands {unused} of {total_devices} surviving "
            f"devices (data axis rounded down to {data}); they are idle "
            "until the next resize", RuntimeWarning, stacklevel=2)
    if pods > 1:
        return ElasticPlan((pods, data, model_parallel),
                           ("pod", "data", "model"), accum, unused)
    return ElasticPlan((data, model_parallel), ("data", "model"), accum,
                       unused)


def find_restart_step(directory: str | Path) -> int | None:
    """The newest step a restart may restore: the highest committed
    manifest whose segments are intact. Skips (never raises on):

    * orphan ``.seg*`` files with no manifest — a drain killed before
      its commit point;
    * a step with a ``.partial`` marker on any segment — a drain torn
      mid-segment;
    * a non-empty checkpoint with no segment files at all — a manifest
      that outlived its segments;
    * a non-empty checkpoint whose segment files are ALL zero-length —
      created-but-never-written segments;
    * a manifest that does not parse.

    Returns ``None`` when no restorable checkpoint exists.
    """
    d = Path(directory)
    for mpath in sorted(d.glob("ckpt_*.manifest.json"), reverse=True):
        stem = mpath.name.replace(".manifest.json", "")
        segs = [p for p in d.glob(stem + ".seg*")
                if not p.name.endswith(".partial")]
        if any(Path(partial_marker(str(p))).exists() for p in segs):
            continue
        if any(p.name.endswith(".partial") for p in d.glob(stem + ".seg*")):
            continue
        try:
            manifest = json.loads(mpath.read_text())
        except (ValueError, OSError):
            continue
        if manifest.get("file_len", 0) > 0:
            try:
                sizes = [p.stat().st_size for p in segs]
            except OSError:
                continue       # a segment vanished under us: not this one
            if not segs or all(sz == 0 for sz in sizes):
                continue
        return int(manifest["step"])
    return None
