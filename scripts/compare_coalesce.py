#!/usr/bin/env python3
"""Time this checkout's coalesce kernel against another checkout's (for
example the parent commit's, unpacked with ``git archive``), on one CUDA
card, in one process.

    python3 scripts/compare_coalesce.py OTHER_CHECKOUT [--reps 10]

Builds both kernel libraries from their own sources (each into its own
checkout's ``build/``, the two builds running together), holds both
kernels to this checkout's ``coalesce_ref`` on the inputs of
``chip_smoke.py``'s coalesce line ([16, 32768] with 2048 live entries,
and with all 32768 live), then times them in turns (other, this, this,
other) with ``chip_smoke.time_ms``. Prints the card's name and power
limit, then one JSON line per shape. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ("import sys; sys.path.insert(0, 'src'); "
         "from repro_torch.kernels import build; "
         "print(build.build_library()[0])")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_coalesce: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.kernels import build, coalesce_kernel, ref

    other = subprocess.Popen([sys.executable, "-c", BUILD],
                             cwd=args.other.resolve(), text=True,
                             stdout=subprocess.PIPE)
    build.load_library()
    out, _ = other.communicate()
    if other.returncode != 0:
        raise RuntimeError(f"the other checkout's build failed: {out}")
    lib = ctypes.CDLL(out.strip().splitlines()[-1])
    lib.repro_coalesce.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.repro_coalesce.restype = ctypes.c_int

    def other_coalesce(o, ln):
        outs = (torch.empty_like(o), torch.empty_like(ln),
                torch.empty(o.shape[0], dtype=torch.int32, device=o.device))
        rc = lib.repro_coalesce(o.data_ptr(), ln.data_ptr(),
                                *(t.data_ptr() for t in outs), *o.shape,
                                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the other coalesce failed: CUDA error {rc}")
        return outs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(1 << 25, dtype=torch.int32, device=dev)
    rows, n = 16, 32768
    for name, live in (("path", 2048), ("all_live", n)):
        o, ln = chip_smoke.coalesce_inputs(torch, rows, n, live, gen, dev)
        want = ref.coalesce_ref(o, ln)
        for fn in (other_coalesce, coalesce_kernel.coalesce):
            err = chip_smoke.max_abs_err(torch, fn(o, ln), want)
            chip_smoke.require(err == 0, f"{fn.__name__} {name} != plain")
        turns = []
        for fn in (other_coalesce, coalesce_kernel.coalesce,
                   coalesce_kernel.coalesce, other_coalesce):
            turns.append(chip_smoke.time_ms(torch, lambda: fn(o, ln),
                                            args.reps, flush))
        b, by = chip_smoke.bound((4 * rows * n + rows) * 4, rows * n * 4)
        print(json.dumps({"shape": [rows, n], "live": live,
                          "other_this_this_other_ms": turns,
                          "bound_ms": b, "bound_by": by,
                          "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
