"""Dry-run: trace every (arch x shape x mesh) cell's step on ``meta``
(the port of the reference's ``launch/dryrun.py``).

The reference lowers and compiles each cell's step onto its production
mesh and reads XLA's memory and cost analyses. The port runs the same
step (``launch.steps.input_specs``: the cell's arguments as ``meta``
tensors, the cell's plan on the emulated production mesh) once under a
``launch.op_analysis.OpCounter``: shapes propagate, nothing is allocated
on any device, and every layer runs, so the counts need no trip counts.
It reports the reference's JSON fields:

* ``flops`` and ``bytes_accessed`` per device: the counter's totals over
  the mesh's devices (the emulation computes each rank of the axes its
  plan uses once, and work along the others once: see
  ``launch/roofline.py``); ``flops_global`` beside them;
* ``collectives``: wire bytes per device by kind, the emulated
  collectives' and (``implied``) those GSPMD inserts for the parameters'
  specs, with ``_counts``;
* ``memory.argument_bytes`` / ``output_bytes`` per device, exact from
  the shapes and specs (each dimension split over the mesh axes its spec
  entry names, rounded up as GSPMD pads); ``temp_bytes`` is null: XLA's
  buffer assignment has no eager counterpart (the card's peak is
  measured instead, ``chip_smoke.py``'s ``roofline`` lines);
* ``params``, ``active_params``, ``seq``, ``global_batch``, ``kind``;
* ``trace_s`` in place of ``lower_s`` / ``compile_s``;
* the roofline's fields of the same trace (``roofline.roofline_fields``:
  the three terms, ``dominant``, ``useful_ratio``,
  ``roofline_fraction``), so one sweep serves both tools.

Mesh kinds: ``single`` (data 16 x model 16), ``multi`` (pod 2 x data 16 x
model 16), and ``one``: one device, no mesh (the plan the card runs).

Usage:
  python -m repro_torch.launch.dryrun --arch yi_34b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out build/dryrun]
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch import configs
from repro_torch.launch import op_analysis, roofline
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import input_specs, plan_for_cell, spec_map
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import unsharded

MESH_KINDS = ("single", "multi", "one")
SKIP_REASON = ("full-attention arch; long_500k needs sub-quadratic "
               "attention (DESIGN.md S5)")
TEMP_NOTE = ("no eager counterpart of XLA's buffer assignment; the card's "
             "peak is measured (chip_smoke.py roofline lines)")


def cell_plan(mesh_kind: str, cell: shp.ShapeCell):
    """``(plan, mesh or None, devices)`` of a mesh kind for ``cell``."""
    if mesh_kind == "one":
        return unsharded(), None, 1
    if mesh_kind not in MESH_KINDS:
        raise ValueError(f"mesh kind {mesh_kind!r} not in {MESH_KINDS}")
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    return plan_for_cell(mesh, cell), mesh, mesh.size


def per_device_bytes(tree, specs, mesh) -> int:
    """The bytes one device holds of ``tree``'s tensors under ``specs``:
    each dimension split over the mesh axes its spec entry names,
    rounded up (GSPMD pads an uneven split); everything on one device
    without a mesh. Non-tensor leaves (the decode state's ``pos``) hold
    none."""
    total = 0

    def add(spec, leaf):
        nonlocal total
        if not isinstance(leaf, torch.Tensor):
            return
        entries = tuple(spec or ()) + (None,) * leaf.ndim
        n = 1
        for d, entry in zip(leaf.shape, entries):
            names = () if entry is None or mesh is None else (
                (entry,) if isinstance(entry, str) else entry)
            n *= -(-d // math.prod(mesh.shape[a] for a in names))
        total += n * leaf.element_size()
    spec_map(add, specs, tree)
    return total


class Trace(NamedTuple):
    cost: op_analysis.CompCost
    devices: int
    argument_bytes: int        # per device
    output_bytes: int          # per device
    trace_s: float
    outputs: object


def trace_cell(arch: str, cell: shp.ShapeCell, mesh_kind: str, *,
               cfg: ModelConfig | None = None, device="meta") -> Trace:
    """Run ``cell``'s step once under a counter on ``mesh_kind``'s plan
    (``cfg`` replaces the arch's config, for a cut depth), with the
    collectives the parameters' specs imply added as
    ``cost.coll_implied``."""
    plan, mesh, n_dev = cell_plan(mesh_kind, cell)
    t0 = time.perf_counter()
    fn, args, arg_specs, out_specs = input_specs(arch, cell, plan, cfg=cfg,
                                                 device=device)
    arg_bytes = per_device_bytes(args, arg_specs, mesh)
    with op_analysis.OpCounter() as counter:
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    if mesh is not None:
        params = []
        spec_map(lambda s, t: params.append((s, t)), arg_specs[0], args[0])
        counter.cost.coll_implied = op_analysis.implied_collectives(
            params, mesh, plan.data_axes, cell.kind)
    return Trace(counter.cost, n_dev, arg_bytes,
                 per_device_bytes(out, out_specs, mesh), trace_s, out)


def _skipped(arch, shape_name, mesh_kind) -> dict:
    return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "status": "skipped", "reason": SKIP_REASON}


def _write(out_dir: Path | None, result: dict) -> None:
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
        name = f"{result['arch']}__{result['shape']}__{result['mesh']}"
        (out_dir / f"{name}.json").write_text(json.dumps(result, indent=2))


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: Path | None = None) -> dict:
    cell = shp.shape(shape_name)
    cfg = configs.get(arch)
    if not shp.applicable(cfg, cell):
        result = _skipped(arch, shape_name, mesh_kind)
        _write(out_dir, result)
        return result
    tr = trace_cell(arch, cell, mesh_kind)
    cost = tr.cost
    coll = dict(cost.coll_bytes)
    coll["implied"] = dict(cost.coll_implied)
    coll["_counts"] = dict(cost.coll_count)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "status": "ok", "devices": tr.devices,
        "trace_s": round(tr.trace_s, 1),
        "flops": cost.flops / tr.devices,
        "bytes_accessed": cost.bytes / tr.devices,
        "memory": {
            "argument_bytes": tr.argument_bytes,
            "output_bytes": tr.output_bytes,
            "temp_bytes": None,
            "temp_bytes_note": TEMP_NOTE,
        },
        "collectives": coll,
        "tensor_devices": sorted(cost.devices),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "seq": cell.seq, "global_batch": cell.global_batch,
        "kind": cell.kind,
        **roofline.roofline_fields(tr, cfg, cell),
    }
    _write(out_dir, result)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=[*MESH_KINDS, "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, c.name) for a, c, _ in
                 shp.all_cells(include_skipped=True)]
    else:
        cells = [(args.arch, args.shape)]

    failures = 0
    t_all = time.perf_counter()
    for arch, shape_name in cells:
        for mesh_kind in meshes:
            name = f"{arch}__{shape_name}__{mesh_kind}"
            path = out_dir / f"{name}.json"
            if args.skip_existing and path.exists():
                prev = json.loads(path.read_text())
                if prev.get("status") in ("ok", "skipped"):
                    print(f"[skip] {name}", flush=True)
                    continue
            try:
                r = run_cell(arch, shape_name, mesh_kind, out_dir)
            except Exception as e:
                failures += 1
                print(f"[FAIL] {name}: {e}", flush=True)
                traceback.print_exc()
                _write(out_dir, {"arch": arch, "shape": shape_name,
                                 "mesh": mesh_kind, "status": "fail",
                                 "error": str(e)})
                continue
            if r["status"] == "skipped":
                print(f"[skipped] {name}: {r['reason']}", flush=True)
                continue
            arg_gib = r["memory"]["argument_bytes"] / 2 ** 30
            print(f"[ok]   {name}: trace={r['trace_s']}s "
                  f"flops/dev={r['flops']:.3e} args/dev={arg_gib:.2f}GiB "
                  f"dom={r['dominant']} frac={r['roofline_fraction']:.3f}",
                  flush=True)
    print(f"[done] {len(cells) * len(meshes)} cells, {failures} failed, "
          f"{time.perf_counter() - t_all:.1f}s", flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
