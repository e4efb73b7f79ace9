"""Serving entry point: prefill + batched greedy decode (the port of the
reference's ``launch/serve.py``; every family the configs hold).

Example (the reduced config, as the reference's CLI serves it):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_9b \
      --batch 4 --prompt-len 32 --gen 16

``--device`` defaults to ``cuda``; ``--device cpu`` runs the plain
versions of the kernels. ``--restore-dir`` loads the weights from the
newest checkpoint in a directory before serving, through the planned
collective read (``checkpoint.restore_checkpoint`` on a
``HostCollectiveIO`` of 8 readers on 2 nodes: ``compile_plan`` of the
read, the node-level window cache unless ``--no-node-cache``, ranged
segment reads), and prints the restore's modeled time and cache hit
ratio beside the generation stats.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch._tree import leaves
from repro_torch.models import transformer as T
from repro_torch.models.config import reduced


def restore_params(restore_dir: str, like_params, *,
                   node_cache: bool = True, n_ranks: int = 8,
                   n_nodes: int = 2):
    """Replace ``like_params`` with the newest checkpoint under
    ``restore_dir`` through the planned collective read. The reader
    topology is the serving host layout (``n_ranks`` readers on
    ``n_nodes`` nodes); the striping comes from the manifest. The
    readers run on the device of ``like_params``' first leaf, and each
    restored leaf lands on its like-leaf's device. Returns ``(params,
    step, timings)``."""
    from repro_torch.checkpoint.checkpoint import restore_checkpoint
    from repro_torch.checkpoint.host_io import HostCollectiveIO

    d = Path(restore_dir)
    steps = sorted(int(p.name[5:13])
                   for p in d.glob("ckpt_*.manifest.json"))
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {restore_dir}")
    path = d / f"ckpt_{steps[-1]:08d}"
    man = json.loads((d / (path.name + ".manifest.json")).read_text())
    io = HostCollectiveIO(n_ranks=n_ranks, n_nodes=n_nodes,
                          stripe_size=man["stripe_size"],
                          stripe_count=man["stripe_count"],
                          device=leaves(like_params)[0].device)
    return restore_checkpoint(path, like_params, io=io,
                              node_cache=node_cache, with_timings=True)


def pick(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Greedy token: argmax over the real vocabulary (the padded columns
    are -inf); ties take the first maximum."""
    col = torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(col < vocab, logits, -torch.inf)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def request_batch(cfg, prompts: torch.Tensor) -> dict:
    """The batch :func:`generate` prefills: the prompts, and for an
    enc-dec config the reference CLI's frames, ``ones([B, enc_seq,
    d_model], f32) * 0.01`` on the prompts' device. A vlm is served on
    tokens alone, as the reference serves it (an image-prefixed request
    goes through ``T.prefill`` with ``prefix_embeds``, then
    ``T.decode_step``)."""
    batch = {"tokens": prompts}
    if cfg.enc_dec:
        batch["frames"] = torch.ones(
            (prompts.shape[0], cfg.enc_seq, cfg.d_model), dtype=torch.float32,
            device=prompts.device) * 0.01
    return batch


def generate(params, cfg, prompts: torch.Tensor, gen_len: int, plan=None,
             decode_plan=None):
    """Greedy generation: prefill (:func:`request_batch`) then
    ``gen_len`` decode steps. Returns the tokens ``[B, gen_len + 1]``.
    ``plan`` is the sharding plan of both, as in the reference;
    ``decode_plan``, where given, replaces it for the decode steps (a
    cell's decode plan turns sequence sharding off:
    ``launch.steps.plan_for_cell``)."""
    if decode_plan is None:
        decode_plan = plan
    logits, state = T.prefill(params, cfg, request_batch(cfg, prompts),
                              plan=plan)
    # pad the caches so decode can extend beyond the prompt
    state = _grow_caches(state, gen_len)
    toks = []
    tok = pick(logits, cfg.vocab)
    for _ in range(gen_len):
        toks.append(tok)
        logits, state = T.decode_step(params, cfg, state, tok,
                                      plan=decode_plan)
        tok = pick(logits, cfg.vocab)
    toks.append(tok)
    return torch.stack(toks, dim=1)


def _grow_caches(state: T.DecodeState, extra: int) -> T.DecodeState:
    """Zero-pad the seq axis of every ``[n_blocks, B, S, ...]`` KV cache;
    a Mamba slot (no KV) keeps its fixed-size states, an enc-dec state
    its ``enc_out``."""
    def grow(c):
        return F.pad(c, (0, 0, 0, 0, 0, extra))
    return state._replace(kv=[None if c is None else (grow(c[0]), grow(c[1]))
                              for c in state.kv])


def build_parser() -> argparse.ArgumentParser:
    """The CLI's arguments: the reference's (``--smoke`` is accepted and
    unread, as there) and ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2_9b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--restore-dir", default=None,
                    help="restore weights from the latest checkpoint in "
                         "this directory through the planned collective "
                         "read before serving")
    ap.add_argument("--no-node-cache", action="store_true",
                    help="disable the node-level read cache on restore "
                         "(per-rank fetch baseline)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced(configs.get(args.arch))
    params = T.init_params(0, cfg, dtype=torch.float32, device=dev)
    if args.restore_dir:
        params, step, rt = restore_params(
            args.restore_dir, params, node_cache=not args.no_node_cache)
        print(f"restored step {step}: modeled {rt.total * 1e3:.3f}ms, "
              f"cache hit ratio {rt.cache_hit_ratio:.2f}, "
              f"{rt.read_bytes} bytes read")
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
