"""Device ms a TAM write spends in stage 1's sort and coalesce of each
local aggregator's window (``kernels.ops.sort_requests_with`` and
``kernels.ops.coalesce``, called from
``rounds.exchange_rounds_write_tam``), summed over its rounds."""
UNIT = "ms"
MOVES = "write_GBps"
WRAPS = ("repro_torch.kernels.ops.sort_requests_with",
         "repro_torch.kernels.ops.coalesce")


def read(trace):
    spans = [trace.span_ms(t) for t in WRAPS]
    if any(not ms for ms in spans):
        return None
    return sum(sum(ms) for ms in spans) / trace.steps
