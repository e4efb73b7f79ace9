"""Bytes, in GB, that a collective write sends across the node axis: the
program's ``slow_hop_bytes`` counter (``repro_torch.trace``), the size of
every part that ``rounds._send`` transposes (the buckets' metadata and
their payload wire), over all rounds. Counted on the one write made
after the traced window (``Tracer.observing``), from the calls of
``trace.count``."""
UNIT = "GB"
MOVES = "write_GBps"
WRAPS = ("repro_torch.trace.count",)
COUNTER = "slow_hop_bytes"


def observe(target, args, kwargs, out, state):
    name, n = args
    if name == COUNTER:
        state["n"] = state.get("n", 0) + n


def read(trace):
    """``None`` where the program has no counters."""
    if trace.span_ms(WRAPS[0]) is None or "n" not in trace.state:
        return None
    return trace.state["n"] / 1e9
