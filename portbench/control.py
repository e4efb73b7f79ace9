"""Read the control of each cell's check at the cell's own size.

    python3 portbench/control.py --seeds 11 12 13 [--seconds 3] \
        [--workload <cell> ...]

The control is the plain reference put in the program's place with one
guarantee that the configurations state broken: every rank's last
request is left out of the file a write leaves, or is not read back. It
runs through ``harness.run`` as the program would, a short window at the
cell's own size, and the harness's own check has to call it not
correct: each line printed gives, for one cell and seed, that check's
numbers, their limits and its ``correct``. The benchmark's own runs
never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def stand_in(cfg, traffic, O, D, file_len, device):
    """The control in the collective's place, with its arguments and
    outputs: a write returns the file and no drops, a read the
    payloads."""
    import torch
    from portbench import reference
    if traffic["direction"] == "read":
        return lambda O, L, C, image: reference.control_read(
            O, L, C, image, D.shape[1])
    zero = torch.zeros(O.shape[0], dtype=torch.int32, device=device)
    stats = {"dropped_requests": zero, "dropped_elems": zero}
    return lambda O, L, C, D: (reference.control_write(O, L, C, D, file_len),
                               stats)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--workload", nargs="*")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("portbench: the control is read on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in args.workload or [w["name"] for w in bench["workloads"]]:
        spec = harness.load_spec(ROOT, cell)
        for seed in args.seeds:
            result, checks = harness.run(spec, seed, args.seconds, False, dev,
                                         time.perf_counter(),
                                         stand_in=stand_in)
            print(json.dumps({
                "cell": cell, "seed": seed, "correct": result["correct"],
                "attempted": result["attempted"],
                "failed": result["failed"],
                "checks": {c["name"]: {"value": c["value"],
                                       "limit": c["limit"]}
                           for c in checks}}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
