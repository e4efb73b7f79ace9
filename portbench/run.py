"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell's configuration, traffic and
metrics are found by name in ``BENCHMARK.json``. With ``--trace 0`` the
result line holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read under ``torch.profiler`` and the benchmark's own
spans. The last line of standard output is the result, a JSON object;
the last lines of standard error are the numbers compared, each beside
its limit. Without a card, or with fewer cards than the cell asks for,
the run fails and prints no result.
"""
import time

T_START = time.perf_counter()   # set-up runs from here to the window

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHES = {"REPRO_TORCH_BUILD_DIR": "build/repro_torch_kernels",
          "TRITON_CACHE_DIR": "build/triton",
          "TORCH_EXTENSIONS_DIR": "build/torch_extensions"}


def card_state() -> str:
    """The card's name, clocks and power, as ``nvidia-smi`` reads them."""
    query = ("name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
             "clocks.mem,temperature.gpu")
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi unavailable ({err})"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, rel in CACHES.items():       # fixed places in the checkout
        os.environ[var] = str(ROOT / rel)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from portbench import harness
    spec = harness.load_spec(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec.chips:
        print(f"portbench: {args.workload} needs {spec.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    print(f"portbench: {torch.cuda.get_device_name(0)}; {card_state()}",
          file=sys.stderr)
    result, checks = harness.run(spec, args.seed, args.seconds,
                                 bool(args.trace), device, T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(f"portbench: {card_state()}", file=sys.stderr)
    for c in checks:
        print(f"check {c['name']} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
