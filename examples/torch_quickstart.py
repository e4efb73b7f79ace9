"""Quickstart of the PyTorch port: TAM collective I/O in five minutes.

1. Build a BTIO-like noncontiguous write pattern for 36 ranks.
2. Write it with classic two-phase I/O and with TAM; verify identical
   files; compare the congestion/timing model.
3. Ask the cost model what the paper's full 16384-process run looks like.

The twin of ``examples/quickstart.py``, through ``repro_torch``. Files go
to a temporary directory, removed at the end.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(the default device is the card).
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import HostCollectiveIO  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.core import optimal_PL, twophase_cost  # noqa: E402
from repro_torch.io_patterns import btio_pattern  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    P = 36  # BTIO wants a square process count
    reqs = btio_pattern(P, n=36)
    io = HostCollectiveIO(n_ranks=P, n_nodes=6, stripe_size=4096,
                          stripe_count=4, device=args.device)
    with tempfile.TemporaryDirectory() as tmp:
        t_2ph = io.write(reqs, f"{tmp}/quickstart", method="twophase")
        t_tam = io.write(reqs, f"{tmp}/quickstart_tam", method="tam",
                         local_aggregators=12)
        file_len = int(max(o[-1] + ln[-1] for o, ln, _ in reqs))
        same = torch.equal(io.read_file(f"{tmp}/quickstart", file_len),
                           io.read_file(f"{tmp}/quickstart_tam", file_len))
    print(f"files identical: {same}")
    print(f"two-phase: {t_2ph.messages_at_ga} msgs at hottest aggregator, "
          f"modeled {t_2ph.total*1e3:.2f} ms")
    print(f"TAM      : {t_tam.messages_at_ga} msgs at hottest aggregator, "
          f"modeled {t_tam.total*1e3:.2f} ms, "
          f"coalesce {t_tam.requests_before} -> {t_tam.requests_after}")

    print("\n--- paper scale (16384 procs, 256 nodes, 56 OSTs) ---")
    for name, wl in (("E3SM-F", cm.e3sm_f), ("E3SM-G", cm.e3sm_g),
                     ("BTIO", cm.btio), ("S3D-IO", cm.s3d)):
        w = wl(16384, 256)
        best, cost = optimal_PL(w)
        print(f"{name:7s} two-phase {twophase_cost(w).total:7.1f}s  "
              f"TAM(P_L={best}) {cost.total:6.1f}s  "
              f"speedup {cm.speedup(w, best):5.1f}x")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
