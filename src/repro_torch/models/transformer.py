"""Decoder-only dense LM: parameters, forward, loss, prefill and decode
(the port of the dense family of the reference's
``models/transformer.py``).

Layer stacking follows the reference: layers are grouped into
super-blocks of ``cfg.block_period`` layers (gemma2's local/global
alternation gives 2), and each position-in-period ("slot") holds its
parameters stacked on a leading ``n_blocks`` axis. The reference scans
over blocks with ``lax.scan``; the port runs a Python loop over them,
indexing the stacked tensors (views, no copies). Decode writes the
stacked KV caches in place, one position per step. ``loss_fn`` is the
training objective; its gradient comes from autograd, the attention's
from the backward kernel on the card (``kernels.flash.FlashAttention``).

Only the ``dense`` family is ported; moe, ssm, hybrid, audio (enc-dec)
and vlm raise ``NotImplementedError`` (ROADMAP queue 1, item 11).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch._device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = dict


def require_dense(cfg: ModelConfig) -> None:
    """Raise for a family the port does not run yet."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported; the port "
            "serves dense LMs (moe, ssm, hybrid, audio and vlm: ROADMAP "
            "queue 1, item 11)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_slot(gen: torch.Generator, cfg: ModelConfig, n_blocks: int,
               dtype) -> Params:
    """One slot's parameters, stacked on a leading n_blocks axis."""
    lead = (n_blocks,)
    norm = torch.zeros((n_blocks, cfg.d_model), dtype=torch.float32,
                       device=gen.device)
    return {"ln1": norm, "ln2": norm.clone(),
            "attn": L.init_attention(gen, cfg, dtype, lead),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, lead)}


def init_params(seed: int, cfg: ModelConfig, dtype=torch.bfloat16,
                device=None) -> Params:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``,
    in the reference's tree: ``embed``, ``final_norm``,
    ``blocks["slots"][j]`` (``ln1``, ``ln2``, ``attn``, ``mlp``), and
    ``unembed`` unless the embeddings are tied. The numbers differ from
    the reference's (another generator); ``weights.params_from_numpy``
    carries the reference's own."""
    require_dense(cfg)
    if cfg.n_layers % cfg.block_period:
        raise ValueError(
            f"{cfg.name}: n_layers {cfg.n_layers} not divisible by "
            f"block period {cfg.block_period}")
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    n_blocks = cfg.n_layers // cfg.block_period
    p: Params = {
        # padded_vocab: the reference's TP-shardable tables; sampling
        # masks the pad
        "embed": L._normal(gen, (cfg.padded_vocab, cfg.d_model), dtype,
                           0.02),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=gen.device),
        "blocks": {"slots": [_init_slot(gen, cfg, n_blocks, dtype)
                             for _ in range(cfg.block_period)]},
    }
    if not cfg.tie_embeddings:
        p["unembed"] = L._normal(gen, (cfg.padded_vocab, cfg.d_model), dtype,
                                 1.0 / math.sqrt(cfg.d_model))
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


class DecodeState(NamedTuple):
    """Per-slot caches stacked [n_blocks, B, S, Hkv, hd]. The
    reference's ``ssm`` and ``enc_out`` fields belong to families the
    port does not run yet."""
    kv: Any           # list per slot: (k, v)
    pos: int          # next write position


def _block_params(tree, i: int):
    """Block ``i`` of a stacked parameter tree (views)."""
    if isinstance(tree, dict):
        return {k: _block_params(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_layer(pl_, x, cfg, i_in_period, positions, cache=None,
                 cache_pos=None):
    """One layer (attention + mlp). Returns (x, new_cache)."""
    h = L.rms_norm(x, pl_["ln1"], cfg.norm_eps)
    a, new_cache = L.attention(pl_["attn"], h, cfg, positions,
                               local=cfg.is_local_layer(i_in_period),
                               cache=cache, cache_pos=cache_pos)
    x = x + a
    h2 = L.rms_norm(x, pl_["ln2"], cfg.norm_eps)
    return x + L.mlp(pl_["mlp"], h2), new_cache


def _super_block(slots, bi: int, x, cfg, positions):
    """The layers of super-block ``bi`` (no caches)."""
    for j in range(len(slots)):
        x, _ = _apply_layer(_block_params(slots[j], bi), x, cfg, j, positions)
    return x


def _run_blocks(blocks, x, cfg, positions,
                decode_state: DecodeState | None = None,
                collect_caches: bool = False, remat: bool = False):
    """Loop over super-blocks. Returns (x, new_decode_state).

    With ``decode_state`` each layer writes its slice of the stacked
    caches in place; with ``collect_caches`` the prefill's keys and
    values are written into newly allocated stacked caches. ``remat``
    (training, no caches) recomputes each super-block in the backward
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``
    of its scanned block."""
    slots = blocks["slots"]
    period = len(slots)
    n_blocks = slots[0]["ln1"].shape[0]
    if remat and decode_state is None and not collect_caches:
        for bi in range(n_blocks):
            x = torch.utils.checkpoint.checkpoint(
                _super_block, slots, bi, x, cfg, positions,
                use_reentrant=False)
        return x, None
    caches = [None] * period
    if decode_state is not None:
        caches = decode_state.kv
    for bi in range(n_blocks):
        for j in range(period):
            layer_cache = None
            if decode_state is not None:
                layer_cache = (caches[j][0][bi], caches[j][1][bi])
            x, (k, v) = _apply_layer(
                _block_params(slots[j], bi), x, cfg, j, positions,
                cache=layer_cache,
                cache_pos=None if decode_state is None else decode_state.pos)
            if collect_caches:
                if caches[j] is None:
                    caches[j] = tuple(
                        torch.empty((n_blocks, *t.shape), dtype=t.dtype,
                                    device=t.device) for t in (k, v))
                caches[j][0][bi] = k
                caches[j][1][bi] = v
    if decode_state is not None:
        return x, decode_state._replace(pos=decode_state.pos + 1)
    if collect_caches:
        return x, DecodeState(kv=caches, pos=x.shape[1])
    return x, None


def _embed_inputs(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Token embeddings [B, S, d], scaled by sqrt(d) in the parameter
    type."""
    return params["embed"][batch["tokens"]] * math.sqrt(cfg.d_model)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].repeat(
        b, 1)


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    unemb = params.get("unembed", params["embed"])
    return L.softcap(torch.einsum("bsd,vd->bsv", x, unemb),
                     cfg.final_logit_softcap)


def forward(params, cfg: ModelConfig, batch: dict, remat: bool = False):
    """Full-sequence forward -> (logits [B, S, V], aux loss). A dense LM
    has no aux loss: it is 0."""
    require_dense(cfg)
    x = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    x, _ = _run_blocks(params["blocks"], x, cfg, _positions(b, s, x.device),
                       remat=remat)
    return (_logits(params, cfg, x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def loss_fn(params, cfg: ModelConfig, batch: dict, remat: bool = False):
    """Causal LM cross-entropy (mean over tokens) + 0.01 x the aux loss,
    as the reference: the padded vocab columns masked out of the
    partition function, logsumexp and the label's logit in f32."""
    logits, aux = forward(params, cfg, batch, remat=remat)
    labels = batch["labels"]
    if cfg.padded_vocab != cfg.vocab:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(col < cfg.vocab, logits, -1e30)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    nll = (lse - ll).mean()
    return nll + 0.01 * aux


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch_size: int, max_seq: int,
                      dtype=torch.bfloat16, device=None) -> DecodeState:
    require_dense(cfg)
    dev = resolve_device(device)
    n_blocks = cfg.n_layers // cfg.block_period
    shape = (n_blocks, batch_size, max_seq, cfg.n_kv_heads, cfg.head_dim)
    kv = [(torch.zeros(shape, dtype=dtype, device=dev),
           torch.zeros(shape, dtype=dtype, device=dev))
          for _ in range(cfg.block_period)]
    return DecodeState(kv=kv, pos=0)


def decode_step(params, cfg: ModelConfig, state: DecodeState,
                tokens: torch.Tensor):
    """One decode step. tokens: [B] int. Returns (logits [B, V], state).

    The caches of ``state`` are written in place (position
    ``state.pos``); the returned state holds the same caches with
    ``pos + 1``."""
    require_dense(cfg)
    x = params["embed"][tokens][:, None, :] * math.sqrt(cfg.d_model)
    positions = torch.full((x.shape[0], 1), state.pos, dtype=torch.int32,
                           device=x.device)
    x, new_state = _run_blocks(params["blocks"], x, cfg, positions,
                               decode_state=state)
    return _logits(params, cfg, x)[:, 0], new_state


def prefill(params, cfg: ModelConfig, batch: dict):
    """Full-sequence forward that also builds the decode caches.

    Returns (last-token logits [B, V], DecodeState with kv caches of
    length S and pos = S) — the serving prefill step.
    """
    require_dense(cfg)
    x = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    x, state = _run_blocks(params["blocks"], x, cfg,
                           _positions(b, s, x.device), collect_caches=True)
    return _logits(params, cfg, x[:, -1:])[:, 0], state
