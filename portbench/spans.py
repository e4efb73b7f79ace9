"""The program's own spans in a ``torch.profiler`` trace, and a run of a
cell that prints them.

The program marks its steps with ``record_function`` annotations named
``repro_torch.<step>`` (``src/repro_torch/trace.py``). :func:`reduce`
charges each device event to the innermost program span that was open on
the host when the event was launched (the CUDA API call, ``cu*``, that
shares the event's correlation id), and each idle stretch of the
device to the
innermost span open at the stretch's midpoint. A span's ``busy`` is its
self time: the device time its own launches took, outside its children;
``total`` adds its children. Where device events overlap, each stretch
of device time is charged once, to the event that started first, so
the spans' ``busy`` and the busy time outside every span add up to the
union of the device events. Annotations of other names (the harness's
window mark) are never spans.

    python3 portbench/spans.py --workload <cell> --seed <n> [--calls 3]

sets the cell up as ``run.py`` does, makes one warm-up call, then
records ``--calls`` calls under the profiler, and prints the span table
to standard error and, as the last line of standard output, a JSON
object: each span's numbers a call, the window's busy and idle time, the
device operations and the program's counters a call.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PREFIX = "repro_torch."
OUTSIDE = "(outside any span)"
FIELDS = ("calls", "host_ms", "busy_ms", "total_ms", "idle_ms")


def _paths(spans, points):
    """For each time in ``points``, the names of the spans open then,
    outermost first (empty outside every span). Spans nest, as the
    calls on one host thread do."""
    spans = sorted(spans, key=lambda x: (x[0], -x[1]))
    out = [()] * len(points)
    stack, i = [], 0
    for k in sorted(range(len(points)), key=points.__getitem__):
        x = points[k]
        while i < len(spans) and spans[i][0] <= x:
            s, t, name = spans[i]
            while stack and stack[-1][0] <= s:
                stack.pop()
            stack.append((t, name))
            i += 1
        while stack and stack[-1][0] <= x:
            stack.pop()
        out[k] = tuple(n for _, n in stack)
    return out


def reduce(w0, w1, spans, launches, dev) -> dict:
    """Each span's calls, host time, device busy time (self and with
    its children) and idle time in the window ``[w0, w1)``, in ms, by
    name; busy and idle outside every span under :data:`OUTSIDE`.

    ``spans``: the program's ``(start, end, name)`` on the host;
    ``launches``: the host time of the launching call of each
    correlation id; ``dev``: the device events ``(start, end, name,
    correlation id)``, cut to the window. Times in ns."""
    table = defaultdict(lambda: dict.fromkeys(FIELDS, 0.0))
    for s, t, name in spans:
        if s < w1 and t > w0:
            table[name]["calls"] += 1
            table[name]["host_ms"] += (t - s) * 1e-6
    dev = sorted(dev)
    # an event whose launching call is not in the trace is outside: -1
    # comes before every span
    at = _paths(spans, [launches.get(c, -1) for _, _, _, c in dev])
    gaps, reach = [], w0

    def charge(path, key, ns):
        table[path[-1] if path else OUTSIDE][key] += ns * 1e-6
        for name in set(path):
            table[name]["total_ms"] += ns * 1e-6

    for (s, t, _, _), path in zip(dev, at):
        if s > reach:
            gaps.append((reach, s))
        if t > reach:
            charge(path, "busy_ms", t - max(s, reach))
            reach = t
    if w1 > reach:
        gaps.append((reach, w1))
    mids = _paths(spans, [(g0 + g1) // 2 for g0, g1 in gaps])
    for (g0, g1), path in zip(gaps, mids):
        table[path[-1] if path else OUTSIDE]["idle_ms"] += (g1 - g0) * 1e-6
    return dict(table)


def from_profile(prof, window_mark: str) -> dict:
    """:func:`reduce` of a stopped profiler's trace, over the first
    annotation named ``window_mark``."""
    from torch.autograd import DeviceType

    from portbench.tracing import NOT_OPS
    events = prof.profiler.kineto_results.events()
    w0, w1 = next((e.start_ns(), e.end_ns()) for e in events
                  if e.name() == window_mark
                  and e.device_type() == DeviceType.CPU)
    spans, launches, dev = [], {}, []
    for e in events:
        s, t, name = e.start_ns(), e.end_ns(), e.name()
        if e.device_type() == DeviceType.CPU:
            if e.is_user_annotation():
                if name.startswith(PREFIX):
                    spans.append((s, t, name))
            elif name.startswith("cu"):
                # a CUDA API call: its id is its launches' own
                # (an operator's ids are another series, which a kernel
                # launched from outside any operator does not link to)
                launches[e.correlation_id()] = s
        elif not (e.is_user_annotation() or name in NOT_OPS) \
                and t > w0 and s < w1:
            dev.append((max(s, w0), min(t, w1), name, e.correlation_id()))
    return reduce(w0, w1, spans, launches, dev)


def format_table(table: dict, calls: int) -> str:
    """The table a call, the largest device busy time first."""
    rows = [f"{'span':<24}{'calls':>8}{'host ms':>12}{'busy ms':>12}"
            f"{'total ms':>12}{'idle ms':>10}"]
    for name, r in sorted(table.items(), key=lambda x: -x[1]["busy_ms"]):
        rows.append(f"{name:<24}{r['calls'] / calls:>8g}"
                    f"{r['host_ms'] / calls:>12.3f}"
                    f"{r['busy_ms'] / calls:>12.3f}"
                    f"{r['total_ms'] / calls:>12.3f}"
                    f"{r['idle_ms'] / calls:>10.3f}")
    return "\n".join(rows)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--calls", type=int, default=3)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness, reference
    from portbench.tracing import WINDOW_MARK, DeviceTrace
    from repro_torch import trace
    if not torch.cuda.is_available():
        print("portbench: the spans are read on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = harness.load_spec(ROOT, args.workload)
    cfg, traffic = spec.config, spec.traffic
    O, L, C, D, file_len = harness.make_inputs(cfg, args.seed, device)
    collective = harness.make_collective(cfg, traffic, O, D, file_len,
                                         device)
    last = (reference.scatter_file(O, L, C, D, file_len)
            if traffic["direction"] == "read" else D)
    collective(O, L, C, last)            # warm-up: every shape
    torch.cuda.synchronize()
    trace.reset_counters()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    t0 = time.perf_counter()
    with torch.profiler.record_function(WINDOW_MARK):
        for _ in range(args.calls):
            collective(O, L, C, last)
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof.stop()
    table = from_profile(prof, WINDOW_MARK)
    d = DeviceTrace(prof)
    print(format_table(table, args.calls), file=sys.stderr)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "calls": args.calls,
        "device": torch.cuda.get_device_name(device),
        "wall_ms": wall * 1e3 / args.calls,
        "window_ms": d.window_s * 1e3 / args.calls,
        "busy_ms": d.busy_s * 1e3 / args.calls,
        "device_ops": d.device_ops / args.calls,
        "spans": {n: {k: v / args.calls for k, v in r.items()}
                  for n, r in table.items()},
        "counters": {k: v / args.calls
                     for k, v in trace.counters().items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
