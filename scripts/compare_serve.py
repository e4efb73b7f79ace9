#!/usr/bin/env python3
"""Time this checkout's greedy serving against another checkout's (for
example the parent commit's, unpacked with ``git archive``), on one CUDA
card.

    python3 scripts/compare_serve.py OTHER_CHECKOUT [--arch gemma2_9b]
        [--runs 5]

Each turn is a process of its own, in the order other, this, this,
other, run from that checkout's root on its own ``src/`` and kernel
build: the config at full width (bf16 weights seeded 0), one warm-up
``launch.serve.generate`` at the reference CLI's defaults (batch 4,
prompt 32, 16 new tokens), then ``--runs`` timed ``generate`` calls, and
as many timed prefills and 16-step decode loops of the same prompts
(host clock around synchronized work). Prints the card's name and power
limit, then one JSON line with every turn's medians. Exits non-zero
without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TURN = r'''
import json, statistics, sys, time
import torch
sys.path.insert(0, "src")
from repro_torch import configs
from repro_torch.kernels import build
from repro_torch.launch import serve
from repro_torch.models import transformer as T
build.build_library()
build.load_library()
arch, runs = sys.argv[1], int(sys.argv[2])
dev = torch.device("cuda", 0)
cfg = configs.get(arch)
params = T.init_params(0, cfg, dtype=torch.bfloat16, device=dev)
gen = torch.Generator(device=dev)
gen.manual_seed(1)
prompts = torch.randint(0, cfg.vocab, (4, 32), generator=gen, device=dev,
                        dtype=torch.int32)


def timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def decode(state, tok):
    for _ in range(16):
        logits, state = T.decode_step(params, cfg, state, tok)
        tok = serve.pick(logits, cfg.vocab)


out = serve.generate(params, cfg, prompts, 16)
rec = {"generate_ms": [], "prefill_ms": [], "decode_ms_per_step": []}
for _ in range(runs):
    rec["generate_ms"].append(timed(
        lambda: serve.generate(params, cfg, prompts, 16))[1])
    (_, state), ms = timed(lambda: T.prefill(params, cfg,
                                             {"tokens": prompts}))
    rec["prefill_ms"].append(ms)
    state = serve._grow_caches(state, 16)
    rec["decode_ms_per_step"].append(timed(
        lambda: decode(state, out[:, 0]))[1] / 16)
print(json.dumps({k: statistics.median(v) for k, v in rec.items()}))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--arch", default="gemma2_9b")
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_serve: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    turns = []
    for name, root in (("other", args.other.resolve()), ("this", ROOT),
                       ("this", ROOT), ("other", args.other.resolve())):
        done = subprocess.run([sys.executable, "-c", TURN, args.arch,
                               str(args.runs)], cwd=root, text=True,
                              capture_output=True)
        if done.returncode != 0:
            raise RuntimeError(f"{name} turn failed: {done.stderr[-2000:]}")
        turns.append({"checkout": name,
                      **json.loads(done.stdout.strip().splitlines()[-1])})
    print(json.dumps({"arch": args.arch, "runs": args.runs,
                      "other_this_this_other": turns, "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
