"""Device ms a collective write spends in the round engine's drain (the
fused sort-and-pack of each window, the masked-max merge and the
accumulate), summed over its rounds: CUDA events around the ``drain``
callable that ``rounds._run_rounds`` is handed."""
UNIT = "ms"
MOVES = "write_GBps"
WRAPS = ("repro_torch.core.rounds._run_rounds(drain)",)


def read(trace):
    ms = trace.span_ms(WRAPS[0])
    return sum(ms) / trace.steps if ms else None
