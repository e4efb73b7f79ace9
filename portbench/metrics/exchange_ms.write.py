"""Device ms a collective write spends in the round engine's exchange
(``core/rounds.py``, ``core/exchange.py``: select, repack, stage 1 for
TAM, bucket and the node-axis transpose), summed over its rounds: CUDA
events around the ``exchange`` callable that ``rounds._run_rounds`` is
handed."""
UNIT = "ms"
MOVES = "write_GBps"
WRAPS = ("repro_torch.core.rounds._run_rounds(exchange)",)


def read(trace):
    ms = trace.span_ms(WRAPS[0])
    return sum(ms) / trace.steps if ms else None
