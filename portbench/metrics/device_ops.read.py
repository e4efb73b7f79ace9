"""Kernels, copies and fills on the card a collective read makes, from
``torch.profiler``: how launch-bound the path is."""
UNIT = "ops"
MOVES = "read_GBps"


def read(trace):
    d = trace.device
    return d.device_ops / trace.steps if d and d.device_ops else None
