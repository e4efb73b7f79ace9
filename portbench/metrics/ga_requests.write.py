"""Requests that reach the global aggregators in one collective write:
the sum of the ``requests_at_ga`` stat that the write returns, the
paper's count of inter-node requests."""
UNIT = "requests"
MOVES = "write_GBps"


def read(trace):
    counts = [int(s["requests_at_ga"].sum()) for s in trace.stats
              if "requests_at_ga" in s]
    if not counts or len(counts) != len(trace.stats):
        return None
    return sum(counts) / len(counts)
