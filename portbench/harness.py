"""One run of one cell: set-up, the measured window, the check of what
the window produced, and the result line.

Everything that belongs to a configuration, a traffic mix or a
per-layer metric is data found by its name in ``BENCHMARK.json``:

* ``configs/<config>.json``: the deployment (rank grid, the pattern and
  its sizes, the I/O knobs, the guarantees), whose ``pattern`` names
  ``patterns/<pattern>.py``, the geometry of its requests;
* ``traffic/<traffic>.json``: the method and direction of the collective
  and the slow-hop codec;
* ``metrics/<metric>.py``: a per-layer metric's reader.

The window runs the collective that set-up built, back to back, each
call ending in a device synchronize (``MPI_File_write_all`` blocks), and
closes at the end of the first call that finishes past ``seconds``.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

import torch

from portbench import reference
from portbench.tracing import WINDOW_MARK, DeviceTrace, Tracer

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Spec:
    """A cell as ``BENCHMARK.json`` states it, its files read."""

    cell: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def load_module(path: Path):
    """Import a file by path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_spec(root: Path, cell: str) -> Spec:
    """The cell ``cell`` of ``root/BENCHMARK.json``, with its
    configuration and traffic read and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    w = cells[cell]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _reports(m, cell)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if m["moves"] in names
                 and _reports(m, cell)]
    return Spec(cell, w["chips"],
                json.loads((root / cfg["file"]).read_text()),
                json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                           .read_text()), e2e, per_layer)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def payload(shape, dtype, seed: int, device) -> torch.Tensor:
    """Every rank's payload, drawn from ``seed`` on ``device`` in one
    call: any value of an integer type, standard normal values of a
    floating one (a solution field: finite, and never a NaN that no
    comparison would match)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if dtype.is_floating_point:
        return torch.randn(shape, dtype=dtype, generator=gen, device=device)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max + 1, shape, dtype=dtype,
                         generator=gen, device=device)


def make_inputs(cfg: dict, seed: int, device):
    """The requests of the configuration's pattern and a payload drawn
    from ``seed``: ``(O, L, C, D, file_len)`` on ``device``."""
    pattern = load_module(HERE / "patterns" / f"{cfg['pattern']}.py")
    O, L, C, data_cap, file_len = pattern.geometry(cfg)
    O, L, C = (torch.as_tensor(x, dtype=torch.int32).to(device)
               for x in (O, L, C))
    D = payload((O.shape[0], data_cap), getattr(torch, cfg["elem"]), seed,
                device)
    return O, L, C, D, file_len


def make_collective(cfg: dict, traffic: dict, O, D, file_len: int, device):
    """The program's collective for this cell, built once. A TAM write
    runs stage 1 on the port's kernels."""
    from repro_torch.core import (IOConfig, RankMesh, contiguous_layout,
                                  make_tam_write, make_twophase_read,
                                  make_twophase_write)
    apn = cfg["aggregators_per_node"]
    mesh = RankMesh(cfg["nodes"], apn, cfg["ranks_per_node"] // apn)
    layout = contiguous_layout(file_len, cfg["nodes"])
    io = IOConfig(req_cap=O.shape[1], data_cap=D.shape[1],
                  slow_hop_codec=traffic.get("slow_hop_codec"), **cfg["io"])
    build = {
        ("tam", "write"): lambda: make_tam_write(
            mesh, layout, io, use_kernels=True, device=device),
        ("twophase", "write"): lambda: make_twophase_write(
            mesh, layout, io, device=device),
        ("twophase", "read"): lambda: make_twophase_read(mesh, layout, io,
                                                         device=device),
    }
    return build[(traffic["method"], traffic["direction"])]()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check(name: str, value, limit) -> dict:
    return {"name": name, "value": value, "limit": limit}


def run(spec: Spec, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=sys.stderr, stand_in=None):
    """Set up, measure, check. Returns ``(result, checks)``: the result
    line's object without its checks, and each number compared with its
    limit.

    ``stand_in(cfg, traffic, O, D, file_len, device)``, where given,
    builds what runs in the program's place (the control of
    ``control.py``): a callable with the collective's arguments and
    outputs."""
    cfg, traffic = spec.config, spec.traffic
    direction = traffic["direction"]
    O, L, C, D, file_len = make_inputs(cfg, seed, device)
    file_bytes = file_len * D.element_size()
    collective = (stand_in or make_collective)(cfg, traffic, O, D, file_len,
                                               device)
    if direction == "read":
        # the file a read finds: the reference's image of the payload
        image = reference.scatter_file(O, L, C, D, file_len)
        step = lambda: collective(O, L, C, image)  # noqa: E731
    else:
        step = lambda: collective(O, L, C, D)  # noqa: E731
    out = step()                     # warm-up: every shape of the window
    _sync(device)
    del out
    readers, tracer, prof = {}, None, None
    if trace:
        readers = {m["name"]: load_module(HERE / "metrics"
                                          / f"{m['name']}.py")
                   for m in spec.per_layer}
        tracer = Tracer(torch, device, readers)
        tracer.install()
        for target, why in tracer.missing.items():
            print(f"portbench: {target}: {why}", file=log)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()

    # ---- the measured window ----------------------------------------
    stats, first, out, n = [], None, None, 0
    _sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    with torch.profiler.record_function(WINDOW_MARK):
        while True:
            out = None               # only the first and this call's output live
            out = step()
            _sync(device)
            n += 1
            if direction == "write":
                stats.append(out[1])
            if first is None:
                first = out
            if time.perf_counter() - t0 >= seconds:
                break
    window_s = time.perf_counter() - t0
    # ------------------------------------------------------------------

    if prof is not None:
        prof.stop()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if tracer is not None:
        # what a reader counts from the calls' arguments (bytes, rows)
        # it counts on one more call, outside the traced window: the
        # inputs fix it, and its own device work stays out of the trace
        tracer.observing = True
        step()
        _sync(device)
        tracer.remove()
    metrics = {}
    if trace:
        dev_trace = DeviceTrace(prof) if device.type == "cuda" else None
        readings = SimpleNamespace(
            steps=n, stats=stats, device=dev_trace,
            peaks=json.loads((HERE / "peaks.json").read_text()),
            span_ms=tracer.span_ms)
        for m in spec.per_layer:
            readings.state = tracer.state[m["name"]]
            value = readers[m["name"]].read(readings)
            if value is None:
                print(f"portbench: {m['name']}: nothing to read in this "
                      "run; left out", file=log)
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        del prof, tracer
    else:
        values = {f"{direction}_GBps": n * file_bytes / window_s / 1e9,
                  "peak_device_GiB": peak / 2**30, "setup_s": setup_s}
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    del collective, step

    # ---- the check, after the window, on the outputs kept ------------
    checks, wrong = [], set()        # the calls of the window found wrong
    kept = (("first", 0, first), ("last", n - 1, out))
    if direction == "write":
        want = reference.scatter_file(O, L, C, D, file_len)
        for name, i, got in kept:
            bad = reference.mismatches(got[0].reshape(-1), want)
            checks.append(_check(f"file_mismatch.{name}", bad, 0))
            wrong |= {i} if bad else set()
        for key in ("dropped_requests", "dropped_elems"):
            per = [int(s[key].sum()) for s in stats]
            checks.append(_check(key, sum(per), 0))
            wrong |= {i for i, v in enumerate(per) if v}
    else:
        want = reference.gather_payloads(O, L, C, image, D.shape[1])
        for name, i, got in kept:
            bad = reference.mismatches(got, want)
            checks.append(_check(f"payload_mismatch.{name}", bad, 0))
            wrong |= {i} if bad else set()
    correct = all(c["value"] <= c["limit"] for c in checks)
    device_rec = {"platform": "gpu" if device.type == "cuda" else "cpu",
                  "kind": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
                  "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": n, "failed": len(wrong),
              "metrics": metrics, "device": device_rec}
    if trace and device.type == "cuda":
        device_rec["busy_s"] = dev_trace.busy_s
        device_rec["window_s"] = dev_trace.window_s
        result["breakdown"] = {
            "device_ops": [list(x) for x in dev_trace.top_ops],
            "idle_gaps": [list(x) for x in dev_trace.idle_gaps]}
    return result, checks
