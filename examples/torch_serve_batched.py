"""Serving example of the PyTorch port: prefill + batched greedy decode
on a reduced gemma2 (local/global attention + softcaps exercised on the
serving path; on the card the flash kernel's routes).

The twin of ``examples/serve_batched.py``, through
``repro_torch.launch.serve``.

Run:  PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]
(the default device is the card).
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.launch.serve import main as serve_main  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    serve_main(["--arch", "gemma2_9b", "--batch", "4", "--prompt-len", "24",
                "--gen", "12"]
               + ([] if args.device is None else ["--device", args.device]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
