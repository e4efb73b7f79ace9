"""Roofline analysis per (arch x shape x mesh) cell, against the NVIDIA
H100's data-sheet peaks (the port of the reference's
``launch/roofline.py``, which reads TPU v5e's).

The three terms, per device, from one traced step
(``launch.dryrun.trace_cell``: the cell's step under a
``launch.op_analysis.OpCounter``, on ``meta`` by default):

  compute    = counted FLOPs / peak (989 TFLOP/s bf16; 67 TFLOP/s for
               f32 products: the port leaves TF32 off)
  memory     = counted bytes / 3.35 TB/s HBM
  collective = collective wire bytes / 450 GB/s NVLink a direction

(``launch/mesh.py``). ``flops_global`` is what the emulation computes:
every rank of the mesh axes the cell's plan uses, once. Along an axis
the emulation does not expand (a plan's replicated work: each model
rank's copy of a data-parallel layer norm, the data ranks' copies of a
replicated batch) it computes once what the devices would each compute,
so redundant work is not counted: ``flops_per_dev`` is ``flops_global /
devices``, and ``useful_ratio`` (``model_flops`` per device over it) is
the port's own, not XLA's. Bytes likewise; the collective bytes are per
device already (``op_analysis``). Pod-crossing traffic has no separate
term: the H100 mesh has one wire.

``model_flops`` (analytic 6·N_active·D plus the attention's terms) is the
reference's, verbatim.

Usage (the sweep is ``launch.dryrun``'s, whose records carry these
fields; ``--table`` reads them):
  python -m repro_torch.launch.roofline --arch yi_34b --shape train_4k --mesh single
  python -m repro_torch.launch.roofline --all [--mesh both] [--out build/dryrun]
  python -m repro_torch.launch.roofline --table  # render markdown from results
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                     PEAK_FLOPS_F32)

_PEAK_BY_DTYPE = {"bfloat16": PEAK_FLOPS_BF16, "float16": PEAK_FLOPS_BF16}


def model_flops(cfg, cell) -> float:
    """Analytic MODEL_FLOPS for the cell (global, per step).

    train:   6 * N_active * tokens  + 12 * attn(S) (fwd+bwd, causal)
    prefill: 2 * N_active * tokens  + 4 * attn(S) / 2
    decode:  2 * N_active * batch   + 4 * B * S_ctx * Hq * hd per layer
    SSD state updates are O(S * d_state * d_inner) — folded into the
    linear-projection 6ND term's margin (documented).
    """
    n_act = cfg.active_param_count()
    gb, s = cell.global_batch, cell.seq
    hq, hd = cfg.n_heads, cfg.head_dim or 0
    n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))

    def attn_fwd(seq):
        total = 0.0
        for i in range(cfg.n_layers):
            if not cfg.is_attn_layer(i):
                continue
            if cfg.is_local_layer(i) and cfg.window:
                eff = min(cfg.window, seq)
                total += 4 * gb * seq * eff * hq * hd / 2
            else:
                total += 4 * gb * seq * seq * hq * hd / 2
        return total

    if cell.kind == "train":
        return 6 * n_act * gb * s + 3 * attn_fwd(s)
    if cell.kind == "prefill":
        return 2 * n_act * gb * s + attn_fwd(s)
    # decode: one token against an S-long cache
    per_layer = 4 * gb * s * hq * hd
    return 2 * n_act * gb + n_attn * per_layer


def roofline_terms(cost, devices: int) -> dict:
    """The three terms in seconds per device, the dominant one and the
    bound (their max), from a counter's totals over ``devices``."""
    t_compute = sum(f / _PEAK_BY_DTYPE.get(dt, PEAK_FLOPS_F32)
                    for dt, f in cost.flops_by_dtype.items()) / devices
    coll = sum(cost.coll_bytes.values()) + sum(cost.coll_implied.values())
    terms = {"compute": t_compute, "memory": cost.bytes / devices / HBM_BW,
             "collective": coll / NVLINK_BW}
    dominant = max(terms, key=terms.get)
    return {"t_compute_s": terms["compute"], "t_memory_s": terms["memory"],
            "t_collective_s": terms["collective"], "dominant": dominant,
            "bound_s": terms[dominant], "coll_bytes_per_dev": coll}


def roofline_fields(tr, cfg, cell) -> dict:
    """The roofline's fields of a traced cell (``dryrun.Trace``)."""
    cost, n_dev = tr.cost, tr.devices
    mf = model_flops(cfg, cell)
    terms = roofline_terms(cost, n_dev)
    return {
        "flops_global": cost.flops,
        "flops_per_dev": cost.flops / n_dev,
        "attention_flops_global": cost.attention_flops,
        "flops_by_dtype": dict(cost.flops_by_dtype),
        "bytes_per_dev": cost.bytes / n_dev,
        "coll_bytes_per_dev": terms["coll_bytes_per_dev"],
        "coll_breakdown": dict(cost.coll_bytes),
        "coll_counts": dict(cost.coll_count),
        "coll_implied": dict(cost.coll_implied),
        "model_flops_global": mf,
        "model_flops_per_dev": mf / n_dev,
        "useful_ratio": (mf / n_dev) / max(cost.flops / n_dev, 1.0),
        "t_compute_s": terms["t_compute_s"],
        "t_memory_s": terms["t_memory_s"],
        "t_collective_s": terms["t_collective_s"],
        "dominant": terms["dominant"],
        "roofline_fraction": (mf / n_dev / PEAK_FLOPS_BF16)
        / max(terms["bound_s"], 1e-30),
        "mem_per_dev": {"argument_bytes": tr.argument_bytes,
                        "output_bytes": tr.output_bytes,
                        "temp_bytes": None},
    }


def analyze_cell(arch: str, shape_name: str, mesh_kind: str,
                 out_dir: Path | None = None, device="meta", *, cfg=None,
                 cell=None) -> dict:
    """The cell's roofline on ``mesh_kind`` (``single``, ``multi``, or
    ``one``: one device, no mesh). ``cfg`` and ``cell`` replace the
    arch's config and the named shape (a cell cut to fit one card: its
    depth, its batch)."""
    from repro_torch import configs
    from repro_torch.launch import shapes as shp
    from repro_torch.launch.dryrun import trace_cell

    cell = cell or shp.shape(shape_name)
    cfg = cfg or configs.get(arch)
    if not shp.applicable(cfg, cell):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped"}
    t0 = time.perf_counter()
    tr = trace_cell(arch, cell, mesh_kind, cfg=cfg, device=device)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "status": "ok", "devices": tr.devices, "device": device,
        "n_layers": cfg.n_layers, "seq": cell.seq,
        "global_batch": cell.global_batch,
        **roofline_fields(tr, cfg, cell),
        "analyze_s": round(time.perf_counter() - t0, 1),
    }
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{arch}__{shape_name}__{mesh_kind}.json").write_text(
            json.dumps(result, indent=2))
    return result


def render_table(out_dir: Path) -> str:
    rows = []
    for f in sorted(out_dir.glob("*.json")):
        r = json.loads(f.read_text())
        if r.get("status") != "ok":
            continue
        rows.append(r)
    lines = [
        "| arch | shape | mesh | compute(s) | memory(s) | collective(s) "
        "| dominant | useful | roofline frac | args/dev (GB) |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute_s']:.2e} | {r['t_memory_s']:.2e} "
            f"| {r['t_collective_s']:.2e} | {r['dominant']} "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.3f} "
            f"| {r['mem_per_dev']['argument_bytes'] / 1e9:.2f} |")
    return "\n".join(lines)


def main(argv=None):
    """``--table`` renders the records under ``--out``; anything else is
    ``launch.dryrun``'s sweep, whose per-cell records carry the roofline's
    fields (one trace a cell)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--table", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    args, rest = ap.parse_known_args(argv)
    if args.table:
        print(render_table(Path(args.out)))
        return
    from repro_torch.launch import dryrun
    dryrun.main([*rest, "--out", args.out])


if __name__ == "__main__":
    main()
