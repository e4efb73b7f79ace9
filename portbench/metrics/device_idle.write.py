"""Share of the traced window of the collective writes in which no
kernel, copy or fill ran on the card: 1 - busy / window, from
``torch.profiler``."""
UNIT = "%"
MOVES = "write_GBps"


def read(trace):
    d = trace.device
    return 100.0 * (1.0 - d.busy_s / d.window_s) if d and d.window_s else None
