"""Element slots, in billions, that a collective write's routing walks:
the program's ``route_slots`` counter (``repro_torch.trace``), rows times
the padded width of every ``exchange.repack_sorted`` and of every
bucketing's element routing, over all rounds. The counts are shapes,
so they are taken on the one write made after the traced window
(``Tracer.observing``), from the calls of ``trace.count``."""
UNIT = "Gslots"
MOVES = "write_GBps"
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
