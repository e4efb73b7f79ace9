"""Element slots, in billions, that a collective read's scatter walks:
the program's ``route_slots`` counter (``repro_torch.trace``), each
round's rows times the payload width, counted on the one read made after
the traced window (``Tracer.observing``), from the calls of
``trace.count``."""
UNIT = "Gslots"
MOVES = "read_GBps"
WRAPS = ("repro_torch.trace.count",)
COUNTER = "route_slots"


def observe(target, args, kwargs, out, state):
    name, n = args
    if name == COUNTER:
        state["n"] = state.get("n", 0) + n


def read(trace):
    """``None`` where the program has no counters."""
    if trace.span_ms(WRAPS[0]) is None or "n" not in trace.state:
        return None
    return trace.state["n"] / 1e9
