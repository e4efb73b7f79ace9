"""Spans around the program's calls, and the reduction of a
``torch.profiler`` trace of the measured window.

The spans are the benchmark's own: a per-layer metric names, in its
module's ``WRAPS``, the program's functions it reads, and
:class:`Tracer` wraps them for the traced run alone. A target is either
a module attribute (``"repro_torch.kernels.ops.coalesce"``: every call is
timed) or a callable argument of one (``"repro_torch.core.rounds
._run_rounds(exchange)"``: every call of the callable that
``_run_rounds`` is handed as ``exchange`` is timed). On the card a span
is a pair of CUDA events, so it measures the device time of the work
enqueued between them; on the CPU it is the host clock.
"""
from __future__ import annotations

import bisect
import importlib
import inspect
import time
from collections import defaultdict

WINDOW_MARK = "portbench.window"
# the profiler's records that are neither device work nor a host
# operation: a launch the full command queue made wait, and its own
# buffer handling
NOT_OPS = ("Command Buffer Full", "Activity Buffer Request")


class _HostEvent:
    """The CPU stand-in of ``torch.cuda.Event``."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class Tracer:
    """Wraps the targets that the given metric modules name and records
    a span of every call. Once ``observing`` is set, it records no more
    spans and hands each call to the modules' ``observe`` instead, which
    may launch device work of its own: the harness sets it after the
    traced window, for one more call.

    ``missing`` maps each target that could not be found to the reason;
    a metric reading one of them gets ``None``."""

    def __init__(self, torch, device, metric_modules: dict):
        self.torch = torch
        self.cuda = device.type == "cuda"
        self.modules = metric_modules
        self.spans = defaultdict(list)
        self.state = {name: {} for name in metric_modules}
        self.missing = {}
        self.observing = False
        self._saved = []

    def _event(self):
        if self.cuda:
            return self.torch.cuda.Event(enable_timing=True)
        return _HostEvent()

    def _timed(self, target, fn, observers=()):
        spans = self.spans[target]

        def run(*args, **kwargs):
            if self.observing:
                out = fn(*args, **kwargs)
                for name, observe in observers:
                    observe(target, args, kwargs, out, self.state[name])
                return out
            t0, t1 = self._event(), self._event()
            t0.record()
            out = fn(*args, **kwargs)
            t1.record()
            spans.append((t0, t1))
            return out
        return run

    def install(self) -> None:
        attrs, args = defaultdict(list), defaultdict(set)
        for name, mod in self.modules.items():
            for target in getattr(mod, "WRAPS", ()):
                observe = getattr(mod, "observe", None)
                if target.endswith(")"):
                    func, arg = target[:-1].split("(")
                    args[func].add(arg)
                else:
                    attrs[target].append((name, observe) if observe else None)
        for target, observers in attrs.items():
            found = self._find(target)
            if found:
                mod, attr, fn = found
                self._set(mod, attr, self._timed(
                    target, fn, [o for o in observers if o]))
        for func, names in args.items():
            found = self._find(func, [f"{func}({a})" for a in names])
            if not found:
                continue
            mod, attr, fn = found
            params = inspect.signature(fn).parameters
            for a in sorted(names - set(params)):
                self.missing[f"{func}({a})"] = f"{func} takes no argument {a!r}"
            self._set(mod, attr, self._wrap_args(
                func, fn, sorted(names & set(params))))

    def _wrap_args(self, func, fn, names):
        sig = inspect.signature(fn)
        timed = self._timed

        def run(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            for a in names:
                bound.arguments[a] = timed(f"{func}({a})", bound.arguments[a])
            return fn(*bound.args, **bound.kwargs)
        return run

    def _find(self, target, names=None):
        mod_name, _, attr = target.rpartition(".")
        try:
            mod = importlib.import_module(mod_name)
            return mod, attr, getattr(mod, attr)
        except (ImportError, AttributeError) as err:
            for n in names or [target]:
                self.missing[n] = f"{target} not found ({err})"
            return None

    def _set(self, mod, attr, fn) -> None:
        self._saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, fn)

    def remove(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()

    def span_ms(self, target):
        """Every recorded span of ``target`` in ms, or ``None`` where
        the target was not found. Call after the device is synchronized."""
        if target in self.missing:
            return None
        return [a.elapsed_time(b) for a, b in self.spans.get(target, [])]


def _union_ns(spans) -> int:
    total, reach = 0, None
    for s, e in sorted(spans):
        if reach is None or e > reach:
            total += e - (s if reach is None else max(s, reach))
            reach = e
    return total


class DeviceTrace:
    """What a ``torch.profiler`` trace of the window says: the window's
    length, the device's busy time (the union of every kernel, copy and
    fill), the device operations, each kernel's time, the operations
    that took most device time and the longest idle gaps by the host
    operation that was running in them."""

    def __init__(self, prof):
        from torch.autograd import DeviceType
        events = prof.profiler.kineto_results.events()
        marks = [e for e in events if e.name() == WINDOW_MARK
                 and e.device_type() == DeviceType.CPU]
        if not marks:
            raise RuntimeError("the trace holds no window mark")
        w0, w1 = marks[0].start_ns(), marks[0].end_ns()
        cpu, dev = [], []
        for e in events:
            if e.name() in (WINDOW_MARK,) + NOT_OPS or e.is_user_annotation():
                continue
            s, t = e.start_ns(), e.end_ns()
            if t <= w0 or s >= w1:
                continue
            if e.device_type() == DeviceType.CPU:
                cpu.append((s, t, e.name(), e.correlation_id()))
            else:
                dev.append((max(s, w0), min(t, w1), e.name(),
                            e.linked_correlation_id()))
        self.window_s = (w1 - w0) * 1e-9
        self.busy_s = _union_ns([(s, t) for s, t, _, _ in dev]) * 1e-9
        self.device_ops = len(dev)
        self.kernel_s = defaultdict(float)
        # a kernel's linked correlation is the host operation that
        # launched it; the CUDA runtime's own calls share the ids
        op_of = {c: n for _, _, n, c in cpu if c and not n.startswith("cuda")}
        by_op = defaultdict(float)
        for s, t, name, link in dev:
            self.kernel_s[name] += (t - s) * 1e-9
            by_op[op_of.get(link, name)] += (t - s) * 1e-9
        self.top_ops = sorted(by_op.items(), key=lambda x: -x[1])[:10]
        self.idle_gaps = self._gaps(w0, w1, cpu, dev)

    @staticmethod
    def _gaps(w0, w1, cpu, dev):
        """Each idle stretch of the device, charged to the innermost host
        operation running at its midpoint."""
        gaps, reach = [], w0
        for s, t in sorted((s, t) for s, t, _, _ in dev):
            if s > reach:
                gaps.append((reach, s))
            reach = max(reach, t)
        if w1 > reach:
            gaps.append((reach, w1))
        ops = sorted((s, t, n) for s, t, n, _ in cpu)
        starts = [s for s, _, _ in ops]
        by_op = defaultdict(float)
        stack, i = [], 0
        for g0, g1 in gaps:           # gaps come in time order
            mid = (g0 + g1) // 2
            j = bisect.bisect_right(starts, mid)
            for s, t, n in ops[i:j]:
                while stack and stack[-1][0] <= s:
                    stack.pop()
                stack.append((t, n))
            i = j
            while stack and stack[-1][0] < mid:
                stack.pop()
            by_op[stack[-1][1] if stack else "host_outside_any_recorded_op"] \
                += (g1 - g0) * 1e-9
        return sorted(by_op.items(), key=lambda x: -x[1])[:10]
