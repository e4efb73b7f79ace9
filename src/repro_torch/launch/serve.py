"""Serving entry point: prefill + batched greedy decode (the port of the
reference's ``launch/serve.py``; dense LMs only).

Example (the reduced config, as the reference's CLI serves it):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_9b \
      --batch 4 --prompt-len 32 --gen 16

``--device`` defaults to ``cuda``; ``--device cpu`` runs the plain
versions of the kernels. The reference's ``--restore-dir`` waits for the
port of the checkpoint layer (ROADMAP queue 1, item 8).
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import reduced


def pick(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Greedy token: argmax over the real vocabulary (the padded columns
    are -inf); ties take the first maximum."""
    col = torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(col < vocab, logits, -torch.inf)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def generate(params, cfg, prompts: torch.Tensor, gen_len: int):
    """Greedy generation: prefill then ``gen_len`` decode steps.
    Returns the tokens ``[B, gen_len + 1]``."""
    logits, state = T.prefill(params, cfg, {"tokens": prompts})
    # pad the caches so decode can extend beyond the prompt
    state = _grow_caches(state, gen_len)
    toks = []
    tok = pick(logits, cfg.vocab)
    for _ in range(gen_len):
        toks.append(tok)
        logits, state = T.decode_step(params, cfg, state, tok)
        tok = pick(logits, cfg.vocab)
    toks.append(tok)
    return torch.stack(toks, dim=1)


def _grow_caches(state: T.DecodeState, extra: int) -> T.DecodeState:
    """Zero-pad the seq axis of every ``[n_blocks, B, S, ...]`` cache."""
    def grow(c):
        return F.pad(c, (0, 0, 0, 0, 0, extra))
    return state._replace(kv=[(grow(k), grow(v)) for k, v in state.kv])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2_9b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = reduced(configs.get(args.arch))
    params = T.init_params(0, cfg, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    t0 = time.time()
    out = generate(params, cfg, prompts, args.gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    n_new = out.shape[1] * out.shape[0]
    print(f"arch={cfg.name} generated {tuple(out.shape)} in {dt:.1f}s "
          f"({n_new / dt:.1f} tok/s) on {dev}")
    print("sample:", out[0][:12].tolist())


if __name__ == "__main__":
    main()
