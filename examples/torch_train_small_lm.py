"""End-to-end training driver of the PyTorch port: train a small yi-arch
LM with the full stack (data pipeline, AdamW, TAM checkpoints).

Defaults are CPU-sized (about 3M parameters, 300 steps);
``--d-model 768 --n-layers 12`` gives the ~100M-parameter configuration
on the card. The twin of ``examples/train_small_lm.py``, through
``repro_torch.launch.train``; checkpoints go to a temporary directory,
removed at the end.

Run:  PYTHONPATH=src python examples/torch_train_small_lm.py \\
          [--device cpu] [--steps 300]
(the default device is the card; other arguments go to the driver).
"""
import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args, rest = ap.parse_known_args(argv)
    rest = rest or ["--steps", "300"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "yi_34b", "--smoke", "--lr", "3e-3", "--ckpt-every", "100",
               "--ckpt-dir", tmp] + rest + \
            ([] if args.device is None else ["--device", args.device])
        return subprocess.call(cmd, env=env)


if __name__ == "__main__":
    sys.exit(main())
