"""The LMs of every family (dense, moe, ssm, hybrid, vlm) and the
enc-dec (audio) variant: parameters, forward, loss, prefill and decode
(the port of the reference's ``models/transformer.py``).

Layer stacking follows the reference: layers are grouped into
super-blocks of ``cfg.block_period`` layers (gemma2's local/global
alternation gives 2, jamba's one attention layer in 8 gives 8), and each
position-in-period ("slot") holds its parameters stacked on a leading
``n_blocks`` axis. A layer is attention or a Mamba2 block, then an MLP,
a top-k MoE or nothing (mamba2 has no MLP). The reference scans over
blocks with ``lax.scan``; the port runs a Python loop over them,
indexing the stacked tensors (views, no copies). Decode writes the
stacked caches in place, one position per step: an attention slot's KV
cache, and a Mamba slot's SSM and conv states. ``loss_fn`` is the
training objective (cross-entropy plus 0.01 x the MoE layers' summed
aux loss); its gradient comes from autograd, the attention's from the
backward kernel on the card (``kernels.flash.FlashAttention``).

Every entry point takes the reference's ``ShardingPlan`` as ``plan=``
(default none: one device, no mesh). Its constraints are the identity
here; a plan with an emulated mesh (``launch.mesh``) sends the MoE
layers through ``moe_sharded`` and a one-token decode's self-attention
through ``layers.decode_attention_sharded``, on a leading rank axis.

The vlm family prepends precomputed image embeddings
(``batch["prefix_embeds"]``, the reference's stub of the vision tower)
to the token embeddings, which shifts every position after them; its
loss leaves the prefix rows out. The enc-dec family runs an encoder
stack (``enc_blocks``, non-causal, over ``batch["frames"]``, the
reference's stub of the audio frontend) and ``enc_norm``, and each
decoder layer adds a cross-attention sub-layer (``xattn``: its
attention parameters and the ``lnx`` norm, stacked one a layer) between
the self-attention and the MLP; prefill keeps the encoder output in the
decode state (``enc_out``) for the decode steps.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch._device import resolve_device
from repro_torch.compat import P
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = dict


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_slot(gen: torch.Generator, cfg: ModelConfig, j: int,
               n_blocks: int, dtype) -> Params:
    """Slot ``j``'s parameters, stacked on a leading n_blocks axis: the
    reference's ``_init_layer`` (the period makes a slot's layers all of
    one kind)."""
    lead = (n_blocks,)
    norm = torch.zeros((n_blocks, cfg.d_model), dtype=torch.float32,
                       device=L.device_of(gen))
    p: Params = {"ln1": norm, "ln2": norm.clone()}
    if cfg.is_attn_layer(j):
        p["attn"] = L.init_attention(gen, cfg, dtype, lead)
    else:
        p["mamba"] = L.init_mamba(gen, cfg, dtype, lead)
    if cfg.is_moe_layer(j):
        p["moe"] = L.init_moe(gen, cfg, dtype, lead)
    elif cfg.d_ff:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, lead)
    return p


def _stack_slots(gen: torch.Generator, cfg: ModelConfig, n_layers: int,
                 dtype) -> Params:
    """``n_layers`` layers as ``{"slots": [...]}``, one slot a position
    in the period (the reference's ``_stack_layers``)."""
    n_blocks = n_layers // cfg.block_period
    return {"slots": [_init_slot(gen, cfg, j, n_blocks, dtype)
                      for j in range(cfg.block_period)]}


def init_params(seed: int, cfg: ModelConfig, dtype=torch.bfloat16,
                device=None) -> Params:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``,
    in the reference's tree: ``embed``, ``final_norm``,
    ``blocks["slots"][j]`` (``ln1``, ``ln2``, ``attn`` or ``mamba``,
    ``moe`` or ``mlp`` where the layer has one), ``unembed`` unless
    the embeddings are tied, and for an enc-dec config ``enc_blocks``
    (``n_enc_layers`` deep), ``enc_norm`` and ``xattn`` (``{"xattn":
    attention, "lnx": norm}`` stacked on ``[n_layers]``). The numbers
    differ from the reference's (another generator);
    ``weights.params_from_numpy`` carries the reference's own. On
    ``device="meta"`` nothing is drawn or allocated: the tree's shapes
    and types (the reference's ``jax.eval_shape`` of its init)."""
    if cfg.n_layers % cfg.block_period:
        raise ValueError(
            f"{cfg.name}: n_layers {cfg.n_layers} not divisible by "
            f"block period {cfg.block_period}")
    dev = resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    p: Params = {
        # padded_vocab: the reference's TP-shardable tables; sampling
        # masks the pad
        "embed": L._normal(gen, (cfg.padded_vocab, cfg.d_model), dtype,
                           0.02),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=L.device_of(gen)),
        "blocks": _stack_slots(gen, cfg, cfg.n_layers, dtype),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = L._normal(gen, (cfg.padded_vocab, cfg.d_model), dtype,
                                 1.0 / math.sqrt(cfg.d_model))
    if cfg.enc_dec:
        p["enc_blocks"] = _stack_slots(gen, cfg, cfg.n_enc_layers, dtype)
        p["enc_norm"] = torch.zeros((cfg.d_model,), dtype=torch.float32,
                                    device=L.device_of(gen))
        p["xattn"] = {
            "xattn": L.init_attention(gen, cfg, dtype, (cfg.n_layers,)),
            "lnx": torch.zeros((cfg.n_layers, cfg.d_model),
                               dtype=torch.float32, device=L.device_of(gen))}
    return p


def param_shardings(cfg: ModelConfig, plan) -> Params:
    """The partition spec tree matching :func:`init_params`' structure
    (the reference's ``param_shardings``, entry for entry, as
    ``compat.P``).

    TP over ``model`` on the contraction-friendly dim and FSDP/ZeRO-3
    over the data axes on the other: in the reference's deployment the
    weights live fully sharded and GSPMD all-gathers each layer's slice
    at use (the dry-run counts those gathers from these specs:
    ``launch.op_analysis.implied_collectives``). The stacked leading
    ``n_blocks`` axis is unsharded. Optimizer states inherit these specs
    (``launch.steps.opt_state_specs``). On one device the port places
    nothing by them."""
    dp, tp = plan.dp, plan.tp

    def _lift(spec: P) -> P:
        return P(None, *spec)

    def attn_spec():
        s = {"wq": _lift(P(dp, tp)), "wk": _lift(P(dp, tp)),
             "wv": _lift(P(dp, tp)), "wo": _lift(P(tp, dp))}
        if cfg.qkv_bias:
            s.update({"bq": _lift(P(tp)), "bk": _lift(P(tp)),
                      "bv": _lift(P(tp))})
        return s

    def mamba_spec():
        return {"wx": _lift(P(dp, tp)), "wz": _lift(P(dp, tp)),
                "wbcdt": _lift(P(dp, None)), "conv": _lift(P(None, None)),
                "A_log": _lift(P(None)), "D": _lift(P(None)),
                "dt_bias": _lift(P(None)), "norm": _lift(P(tp)),
                "out_proj": _lift(P(tp, dp))}

    def moe_spec():
        return {"router": _lift(P(dp, None)),
                "wi": _lift(P(tp, dp, None)), "wg": _lift(P(tp, dp, None)),
                "wo": _lift(P(tp, None, dp))}

    def mlp_spec():
        return {"wi": _lift(P(dp, tp)), "wg": _lift(P(dp, tp)),
                "wo": _lift(P(tp, dp))}

    def layer_spec(i: int):
        s = {"ln1": _lift(P(None)), "ln2": _lift(P(None))}
        if cfg.is_attn_layer(i):
            s["attn"] = attn_spec()
        else:
            s["mamba"] = mamba_spec()
        if cfg.is_moe_layer(i):
            s["moe"] = moe_spec()
        elif cfg.d_ff:
            s["mlp"] = mlp_spec()
        return s

    specs: Params = {
        "embed": P(tp, dp),
        "final_norm": P(None),
        "blocks": {"slots": [layer_spec(j)
                             for j in range(cfg.block_period)]},
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = P(tp, dp)
    if cfg.enc_dec:
        specs["enc_blocks"] = {"slots": [layer_spec(0)]}
        specs["enc_norm"] = P(None)
        specs["xattn"] = {"xattn": attn_spec(), "lnx": _lift(P(None))}
    return specs


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


class DecodeState(NamedTuple):
    """Per-slot caches stacked on a leading n_blocks axis. An attention
    slot has ``kv[j] = (k, v)`` ``[n_blocks, B, S, Hkv, hd]`` and
    ``ssm[j] = None``; a Mamba slot has ``kv[j] = None`` and ``ssm[j] =
    (ssm_state [n_blocks, B, nh, ds, hd] f32, conv_state [n_blocks, B,
    d_conv - 1, di + 2 ds])``, whose shapes do not depend on the
    history. ``enc_out`` is the enc-dec encoder's output [B, S_enc, d]
    that every decode step's cross-attention reads (None otherwise)."""
    kv: Any           # list per slot: (k, v) or None
    ssm: Any          # list per slot: (ssm_state, conv_state) or None
    pos: int          # next write position
    enc_out: Any = None


def _block_params(tree, i: int):
    """Block ``i`` of a stacked parameter tree (views)."""
    if isinstance(tree, dict):
        return {k: _block_params(v, i) for k, v in tree.items()}
    return tree[i]


def _layer_params(slot, xattn, bi: int):
    """Block ``bi``'s parameters of a slot, with block ``bi``'s
    cross-attention (``xattn``, stacked one a layer: the reference's
    enc-dec has a period of 1) merged in where there is one."""
    p = _block_params(slot, bi)
    if xattn is not None:
        p.update(_block_params(xattn, bi))
    return p


def _apply_layer(pl_, x, cfg, i_in_period, positions, cache=None,
                 cache_pos=None, enc_out=None, causal=True, plan=None):
    """One layer (attention-or-mamba, then with ``enc_out`` the
    cross-attention on it, then mlp-or-moe). ``cache`` is the layer's
    ``(kv, ssm)`` pair in decode, else None; ``causal`` the
    self-attention's mask without a cache. Returns (x, new_cache, aux):
    new_cache is ``((k, v), None)`` or ``(None, (ssm_state,
    conv_state))``, aux the MoE's aux loss (None without a MoE)."""
    h = L.rms_norm(x, pl_["ln1"], cfg.norm_eps)
    if "attn" in pl_:
        a, kv = L.attention(pl_["attn"], h, cfg, positions,
                            local=cfg.is_local_layer(i_in_period),
                            cache=None if cache is None else cache[0],
                            cache_pos=cache_pos, causal=causal, plan=plan)
        new_cache = (kv, None)
    else:
        a, ssm = L.mamba_block(pl_["mamba"], h, cfg,
                               state=None if cache is None else cache[1])
        new_cache = (None, ssm)
    x = x + a
    if enc_out is not None:
        xa, _ = L.attention(pl_["xattn"],
                            L.rms_norm(x, pl_["lnx"], cfg.norm_eps), cfg,
                            positions, local=False, xattn_kv=enc_out)
        x = x + xa
    aux = None
    if "moe" in pl_:
        mo, aux = L.moe(pl_["moe"], L.rms_norm(x, pl_["ln2"], cfg.norm_eps),
                        cfg, plan=plan)
        x = x + mo
    elif "mlp" in pl_:
        x = x + L.mlp(pl_["mlp"], L.rms_norm(x, pl_["ln2"], cfg.norm_eps))
    return x, new_cache, aux


def _add_aux(total, aux):
    return total if aux is None else (aux if total is None else total + aux)


def _super_block(slots, bi: int, x, cfg, positions, xattn=None,
                 enc_out=None, causal=True, plan=None):
    """The layers of super-block ``bi`` (no caches) -> (x, aux or
    None)."""
    aux = None
    for j in range(len(slots)):
        x, _, a = _apply_layer(_layer_params(slots[j], xattn, bi), x, cfg,
                               j, positions, enc_out=enc_out, causal=causal,
                               plan=plan)
        aux = _add_aux(aux, a)
    return x, aux


def _stacked_like(n_blocks: int, t: torch.Tensor) -> torch.Tensor:
    return torch.empty((n_blocks, *t.shape), dtype=t.dtype, device=t.device)


def _run_blocks(blocks, x, cfg, positions, xattn=None, enc_out=None,
                decode_state: DecodeState | None = None, causal=True,
                collect_caches: bool = False, remat: bool = False,
                plan=None):
    """Loop over super-blocks. Returns (x, new_decode_state, aux): aux
    is the MoE layers' summed aux loss, or None for a model without MoE
    layers. With ``xattn`` (the decoder's cross-attention parameters,
    stacked one a layer) and ``enc_out`` every layer cross-attends to
    ``enc_out``; ``causal`` is the self-attention's mask without a cache
    (the encoder's is not).

    With ``decode_state`` each layer writes its slice of the stacked
    caches in place (KV at ``pos``; the SSM and conv states replaced);
    with ``collect_caches`` the prefill's keys and values, and its SSM
    and conv handoff states, are written into newly allocated stacked
    caches. ``remat`` (training, no caches) recomputes each super-block
    in the backward (``torch.utils.checkpoint``), as the reference's
    ``jax.checkpoint`` of its scanned block."""
    slots = blocks["slots"]
    period = len(slots)
    n_blocks = slots[0]["ln1"].shape[0]
    if xattn is not None and period != 1:
        raise ValueError(f"{cfg.name}: cross-attention is stacked one a "
                         f"layer; a block period of {period} is not taken")
    aux = None
    if remat and decode_state is None and not collect_caches:
        for bi in range(n_blocks):
            x, a = torch.utils.checkpoint.checkpoint(
                _super_block, slots, bi, x, cfg, positions, xattn, enc_out,
                causal, plan, use_reentrant=False)
            aux = _add_aux(aux, a)
        return x, None, aux
    kv, ssm = [None] * period, [None] * period
    if decode_state is not None:
        kv, ssm = decode_state.kv, decode_state.ssm
    for bi in range(n_blocks):
        for j in range(period):
            layer_cache = None
            if decode_state is not None:
                layer_cache = tuple(None if c[j] is None else
                                    (c[j][0][bi], c[j][1][bi])
                                    for c in (kv, ssm))
            x, new_cache, a = _apply_layer(
                _layer_params(slots[j], xattn, bi), x, cfg, j, positions,
                cache=layer_cache,
                cache_pos=None if decode_state is None else decode_state.pos,
                enc_out=enc_out, causal=causal, plan=plan)
            aux = _add_aux(aux, a)
            if decode_state is None and not collect_caches:
                continue
            for caches, pair in zip((kv, ssm), new_cache):
                if pair is None or (caches is kv and decode_state is not None):
                    continue    # decode attention wrote its KV in place
                if caches[j] is None:
                    caches[j] = tuple(_stacked_like(n_blocks, t)
                                      for t in pair)
                caches[j][0][bi] = pair[0]
                caches[j][1][bi] = pair[1]
    if decode_state is not None:
        return x, decode_state._replace(pos=decode_state.pos + 1), aux
    if collect_caches:
        return x, DecodeState(kv=kv, ssm=ssm, pos=x.shape[1]), aux
    return x, None, aux


def _embed_inputs(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """The decoder's input [B, S, d]: token embeddings scaled by sqrt(d)
    in the parameter type, after a vlm's ``prefix_embeds`` (cast to that
    type) where the batch has them; an audio config that is not enc-dec
    takes ``frames`` as they are."""
    emb_scale = math.sqrt(cfg.d_model)
    if cfg.frontend == "vision" and "prefix_embeds" in batch:
        tok = params["embed"][batch["tokens"]] * emb_scale
        return torch.cat([batch["prefix_embeds"].to(tok.dtype), tok], dim=1)
    if cfg.frontend == "audio" and not cfg.enc_dec:
        return batch["frames"]
    return params["embed"][batch["tokens"]] * emb_scale


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].repeat(
        b, 1)


def _encode(params, cfg: ModelConfig, frames: torch.Tensor, plan=None):
    """The enc-dec encoder: its blocks over ``frames`` [B, S_enc, d],
    non-causal, then ``enc_norm``. Runs in the type ``frames`` and the
    weights promote to (f32 frames: f32, as in the reference)."""
    b, s, _ = frames.shape
    x, _, _ = _run_blocks(params["enc_blocks"], frames, cfg,
                          _positions(b, s, frames.device), causal=False,
                          plan=plan)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    unemb = params.get("unembed", params["embed"])
    return L.softcap(torch.einsum("bsd,vd->bsv", x, unemb),
                     cfg.final_logit_softcap)


def forward(params, cfg: ModelConfig, batch: dict, remat: bool = False, *,
            plan=None):
    """Full-sequence forward -> (logits [B, S, V], aux loss): the MoE
    layers' aux losses summed, or an f32 zero for a model without
    them. An enc-dec config runs its encoder over ``batch["frames"]``
    first (never rematerialised, as in the reference)."""
    x = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    enc_out = (_encode(params, cfg, batch["frames"], plan) if cfg.enc_dec
               else None)
    x, _, aux = _run_blocks(params["blocks"], x, cfg,
                            _positions(b, s, x.device),
                            xattn=params.get("xattn"), enc_out=enc_out,
                            remat=remat, plan=plan)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, cfg, x), aux


def loss_fn(params, cfg: ModelConfig, batch: dict, remat: bool = False, *,
            plan=None):
    """Causal LM cross-entropy (mean over tokens) + 0.01 x the aux loss,
    as the reference: a vlm's prefix rows left out, the padded vocab
    columns masked out of the partition function, logsumexp and the
    label's logit in f32."""
    logits, aux = forward(params, cfg, batch, remat=remat, plan=plan)
    labels = batch["labels"]
    if cfg.frontend == "vision" and "prefix_embeds" in batch:
        logits = logits[:, batch["prefix_embeds"].shape[1]:]
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
                      dtype=torch.bfloat16, device=None,
                      enc_out=None, *, plan=None) -> DecodeState:
    """Zero caches for ``batch_size`` sequences of up to ``max_seq``
    positions: KV in ``dtype`` for attention slots; for Mamba slots the
    SSM state in f32 and the conv state in ``dtype``, both independent
    of ``max_seq``; ``enc_out`` as given. ``plan`` places nothing on
    one device (the reference constrains the KV caches to
    ``plan.kv_cache()``)."""
    dev = resolve_device(device)
    n_blocks = cfg.n_layers // cfg.block_period
    kv, ssm = [], []
    for j in range(cfg.block_period):
        if cfg.is_attn_layer(j):
            shape = (n_blocks, batch_size, max_seq, cfg.n_kv_heads,
                     cfg.head_dim)
            kv.append((torch.zeros(shape, dtype=dtype, device=dev),
                       torch.zeros(shape, dtype=dtype, device=dev)))
            ssm.append(None)
        else:
            mc = cfg.mamba
            di, ds = mc.d_inner(cfg.d_model), mc.d_state
            nh, hd = mc.n_heads(cfg.d_model), mc.head_dim
            kv.append(None)
            ssm.append((torch.zeros((n_blocks, batch_size, nh, ds, hd),
                                    dtype=torch.float32, device=dev),
                        torch.zeros((n_blocks, batch_size, mc.d_conv - 1,
                                     di + 2 * ds), dtype=dtype, device=dev)))
    return DecodeState(kv=kv, ssm=ssm, pos=0, enc_out=enc_out)


def decode_step(params, cfg: ModelConfig, state: DecodeState,
                tokens: torch.Tensor, *, plan=None):
    """One decode step. tokens: [B] int. Returns (logits [B, V], state).

    The caches of ``state`` are written in place (KV at position
    ``state.pos``, the SSM and conv states replaced); the returned state
    holds the same caches with ``pos + 1`` (and an enc-dec's
    ``enc_out``, which the cross-attention reads)."""
    x = params["embed"][tokens][:, None, :] * math.sqrt(cfg.d_model)
    positions = torch.full((x.shape[0], 1), state.pos, dtype=torch.int32,
                           device=x.device)
    enc_out = state.enc_out if cfg.enc_dec else None
    x, new_state, _ = _run_blocks(params["blocks"], x, cfg, positions,
                                  xattn=params.get("xattn"), enc_out=enc_out,
                                  decode_state=state, plan=plan)
    return _logits(params, cfg, x)[:, 0], new_state


def prefill(params, cfg: ModelConfig, batch: dict, *, plan=None):
    """Full-sequence forward that also builds the decode caches.

    Returns (last-token logits [B, V], DecodeState with kv caches of
    length S (a vlm's prefix rows included), the SSM and conv handoff
    states, pos = S, and an enc-dec's encoder output) — the serving
    prefill step.
    """
    x = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    enc_out = (_encode(params, cfg, batch["frames"], plan) if cfg.enc_dec
               else None)
    x, state, _ = _run_blocks(params["blocks"], x, cfg,
                              _positions(b, s, x.device),
                              xattn=params.get("xattn"), enc_out=enc_out,
                              collect_caches=True, plan=plan)
    return (_logits(params, cfg, x[:, -1:])[:, 0],
            state._replace(enc_out=enc_out))
