"""Model building blocks: norms, RoPE, softcap, attention, the SwiGLU
MLP, top-k MoE and the Mamba2 SSD block (the port of the reference's
``models/layers.py``).

Pure functions over explicit parameter dicts, as in the reference. The
reference threads a ``ShardingPlan`` through every layer; the port's
(``models/sharding.py``) constrains nothing (one device holds every
rank), and a plan with a mesh sends two layers through their mesh
paths, emulated on a leading rank axis (``compat``): the decode
attention over a sequence-sharded KV cache
(:func:`decode_attention_sharded`, flash-decoding over the model axis)
and the MoE's explicitly partitioned dispatch (``moe_sharded.py``).
Attention on a CUDA tensor runs the Hopper kernel through
``kernels.ops.fused_attention`` (and, where an input requires grad, its
backward kernel in the backward pass); on a CPU tensor it runs the plain
version, ``kernels.ref.flash_attention_ref``, which autograd
differentiates. The dense matrix products are ``torch.einsum`` calls,
as the reference leaves them to XLA; so are the MoE's dispatch (a
stable sort, prefix sums, index writes and gathers), the SSD scan and
the sharded decode attention, which the reference writes in ``jnp``
with no Pallas kernel. The attention's projections and the MLP promote
mixed operand types as ``jnp.einsum`` does (:func:`_mm`): the enc-dec
reference feeds f32 frames to bf16 weights, so its encoder runs in f32,
and its decoder's cross-attention takes bf16 queries against f32 keys
and values.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import compat as C
from repro_torch.compat import P
from repro_torch.kernels import ops, ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe_sharded import moe_sharded

# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding. x: [..., S, H, head_dim], positions: [..., S].
    Angles in f32, whatever x's type."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freq  # [..., S, half]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, dtype, scale: float):
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device).mul_(scale)


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.bfloat16, lead: tuple = ()) -> dict:
    """Projections stored FLAT ([d, h*hd]), as in the reference. ``lead``
    prepends axes (the stacked blocks)."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": _normal(gen, (*lead, d, hq * hd), dtype, s),
        "wk": _normal(gen, (*lead, d, hkv * hd), dtype, s),
        "wv": _normal(gen, (*lead, d, hkv * hd), dtype, s),
        "wo": _normal(gen, (*lead, hq * hd, d), dtype,
                      1.0 / math.sqrt(hq * hd)),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros((*lead, n * hd), dtype=dtype,
                                  device=gen.device)
    return p


def _mm(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two operands in the type JAX promotes them to
    (``torch.promote_types``: f32 with bf16 gives f32); operands of one
    type pass unconverted. ``torch.einsum`` itself refuses mixed
    types."""
    t = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(t), b.to(t))


def _proj_heads(x, w, b, n_heads: int, hd: int):
    b_, s_, _ = x.shape
    y = _mm("bsd,de->bse", x, w)
    if b is not None:
        y = y + b
    return y.reshape(b_, s_, n_heads, hd)


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor):
    hd = cfg.head_dim
    q = _proj_heads(x, p["wq"], p.get("bq"), cfg.n_heads, hd)
    k = _proj_heads(x, p["wk"], p.get("bk"), cfg.n_kv_heads, hd)
    v = _proj_heads(x, p["wv"], p.get("bv"), cfg.n_kv_heads, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def flash_attention(q, k, v, *, causal: bool, window: int | None,
                    logit_cap: float | None, q_offset: int,
                    kv_len: int | None = None) -> torch.Tensor:
    """GQA attention. q: [B, Sq, Hq, hd]; k, v: [B, Skv, Hkv, hd].
    q_offset: position of q[0] within the kv sequence; kv_len: the valid
    kv prefix (decode cache), or None. CUDA tensors go through the
    Hopper kernel (``ops.fused_attention``), CPU tensors through the
    plain version."""
    if q.device.type == "cuda":
        return ops.fused_attention(q, k, v, causal=causal, window=window,
                                   logit_cap=logit_cap, q_offset=q_offset,
                                   kv_len=kv_len)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   logit_cap=logit_cap, q_offset=q_offset,
                                   kv_len=kv_len)


def decode_attention_sharded(q, k_cache, v_cache, *, cache_pos: int,
                             window: int | None, logit_cap: float | None,
                             plan) -> torch.Tensor:
    """Decode attention with the KV cache sequence-sharded over the
    model axis — flash-decoding: each model rank computes a partial
    softmax over its ``S / n_model`` cache rows (logits masked to
    ``kvpos <= pos`` and the window, filled with -1e30), and the
    partials merge through ``pmax`` of the row max, ``psum`` of l and
    ``psum`` of the product of the bf16-rounded probabilities with v.

    q: [B, 1, Hq, hd]; caches: [B, S, Hkv, hd]. Returns [B, 1, Hq*hd] in
    q's type. The logits and the products sum in f32 (the reference's
    ``preferred_element_type``): the operands are converted exactly
    first. The probabilities are rounded to bf16 whatever the cache's
    type and promoted against it. Raises ``ValueError`` where the cache
    length or the batch does not divide over the ranks."""
    mesh, tp, dp = plan.mesh, plan.tp, plan.dp
    scale = 1.0 / math.sqrt(q.shape[-1])

    def fn(R, qb, kc, vc):
        b, _, hq, hd = qb.shape[R.n:]
        s_loc, hkv = kc.shape[R.n + 1], kc.shape[R.n + 2]
        g = hq // hkv
        lead = qb.shape[:R.n]
        kvpos = (C.axis_index(R, tp, kc.device, local_ndim=1) * s_loc
                 + torch.arange(s_loc, device=kc.device))
        qr = qb.reshape(*lead, b, hkv, g, hd)
        t = torch.promote_types(qb.dtype, kc.dtype)
        logits = torch.einsum("...bkgd,...bskd->...bkgs", qr.to(t).float(),
                              kc.to(t).float()) * scale
        logits = softcap(logits, logit_cap)
        mask = kvpos <= cache_pos
        if window is not None:
            mask = mask & (cache_pos - kvpos < window)
        logits = torch.where(mask[..., None, None, None, :], logits, -1e30)
        mg = C.pmax(logits.amax(dim=-1), R, tp)
        probs = torch.exp(logits - mg[..., None])
        l_ = C.psum(probs.sum(dim=-1), R, tp)
        pt = torch.promote_types(torch.bfloat16, vc.dtype)
        pv = torch.einsum("...bkgs,...bskd->...bkgd",
                          probs.to(torch.bfloat16).to(pt).float(),
                          vc.to(pt).float())
        acc = C.psum(pv, R, tp)
        out = acc / torch.clamp(l_[..., None], min=1e-30)
        return out.reshape(*out.shape[:R.n], b, 1, hq * hd).to(qb.dtype)

    return C.shard_map(
        fn, mesh, in_specs=(P(dp, None, None, None), P(dp, tp, None, None),
                            P(dp, tp, None, None)),
        out_specs=P(dp, None, None),
        axes=tuple(plan.data_axes) + (tp,))(q, k_cache, v_cache)


def attention(p: dict, x: torch.Tensor, cfg: ModelConfig, positions, *,
              local: bool, cache: tuple | None = None,
              cache_pos: int | None = None,
              xattn_kv: torch.Tensor | None = None, causal: bool = True,
              plan=None):
    """Full attention sub-layer.

    Modes:
      prefill: cache None -> flash attention over x itself, causal unless
        the caller says otherwise (the enc-dec encoder passes
        ``causal=False``). Returns (out, (k, v)) so prefill can build the
        cache.
      decode: cache=(k_cache, v_cache) [B, S_max, Hkv, hd], cache_pos =
        the write position (an int). x is [B, 1, d]. The new keys and
        values are written into the caches IN PLACE (the reference's
        ``dynamic_update_slice`` returns new arrays); the caches returned
        are the ones passed in. With a mesh'd ``plan`` a one-token decode
        reads the cache through :func:`decode_attention_sharded`.
      cross-attention (enc-dec): ``xattn_kv`` = the encoder output
        [B, S_enc, d]; q from x, k and v from it, no rope, no mask, no
        cache. q, k and v go to the attention in their promoted type (the
        reference's attention promotes bf16 q against f32 keys) and the
        output comes back in q's. Returns (out, None).
    """
    window = cfg.window if local else None
    if xattn_kv is not None:
        hd = cfg.head_dim
        q = _proj_heads(x, p["wq"], p.get("bq"), cfg.n_heads, hd)
        k = _proj_heads(xattn_kv, p["wk"], p.get("bk"), cfg.n_kv_heads, hd)
        v = _proj_heads(xattn_kv, p["wv"], p.get("bv"), cfg.n_kv_heads, hd)
        t = torch.promote_types(q.dtype, k.dtype)
        out = flash_attention(q.to(t), k.to(t), v.to(t), causal=False,
                              window=None, logit_cap=cfg.attn_logit_softcap,
                              q_offset=0).to(q.dtype)
        return _mm("bse,ed->bsd", out.reshape(*out.shape[:2], -1),
                   p["wo"]), None
    q, k, v = _qkv(p, x, cfg, positions)
    if cache is None:
        out = flash_attention(q, k, v, causal=causal, window=window,
                              logit_cap=cfg.attn_logit_softcap, q_offset=0)
        new_cache = (k, v)
    else:
        k_cache, v_cache = cache
        s = x.shape[1]
        if cache_pos + s > k_cache.shape[1]:
            raise ValueError(f"cache of {k_cache.shape[1]} positions is full "
                             f"at {cache_pos} (grow it before decoding)")
        k_cache[:, cache_pos:cache_pos + s] = k
        v_cache[:, cache_pos:cache_pos + s] = v
        if plan is not None and plan.mesh is not None and s == 1:
            out = decode_attention_sharded(
                q, k_cache, v_cache, cache_pos=cache_pos, window=window,
                logit_cap=cfg.attn_logit_softcap, plan=plan)
            return _mm("bse,ed->bsd", out, p["wo"]), (k_cache, v_cache)
        out = flash_attention(q, k_cache, v_cache, causal=False,
                              window=window,
                              logit_cap=cfg.attn_logit_softcap,
                              q_offset=cache_pos, kv_len=cache_pos + 1)
        new_cache = (k_cache, v_cache)
    out = out.reshape(*out.shape[:2], -1)
    return _mm("bse,ed->bsd", out, p["wo"]), new_cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d: int, f: int, dtype=torch.bfloat16,
             lead: tuple = ()) -> dict:
    return {
        "wi": _normal(gen, (*lead, d, f), dtype, 1.0 / math.sqrt(d)),
        "wg": _normal(gen, (*lead, d, f), dtype, 1.0 / math.sqrt(d)),
        "wo": _normal(gen, (*lead, f, d), dtype, 1.0 / math.sqrt(f)),
    }


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = _mm("bsd,df->bsf", x, p["wi"])
    g = _mm("bsd,df->bsf", x, p["wg"])
    return _mm("bsf,fd->bsd", F.silu(g) * h, p["wo"])


# ---------------------------------------------------------------------------
# MoE (top-k, sort-based dispatch with capacity dropping)
# ---------------------------------------------------------------------------


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
             lead: tuple = ()) -> dict:
    """The router in f32 ``[d, E]`` and the experts' SwiGLU weights
    ``[E, d, f]`` / ``[E, f, d]``, as the reference's ``init_moe``."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    return {
        "router": _normal(gen, (*lead, d, e), torch.float32,
                          1.0 / math.sqrt(d)),
        "wi": _normal(gen, (*lead, e, d, f), dtype, 1.0 / math.sqrt(d)),
        "wg": _normal(gen, (*lead, e, d, f), dtype, 1.0 / math.sqrt(d)),
        "wo": _normal(gen, (*lead, e, f, d), dtype, 1.0 / math.sqrt(f)),
    }


class MoERoute(NamedTuple):
    """One MoE call's routing: ``gates`` and ``eids`` ``[N, k]`` (each
    token's top-k experts, ties to the lower index, gates renormalised),
    the load-balancing ``aux`` loss, ``order`` (the stable sort of the
    flattened ``(token, k)`` entries by expert), ``ok`` (in that sorted
    order: the entry fits its expert's ``cap`` slots) and ``slot`` (its
    row of the ``[E * cap]`` dispatch buffer; ``E * cap`` for a dropped
    entry)."""
    gates: torch.Tensor
    eids: torch.Tensor
    aux: torch.Tensor
    order: torch.Tensor
    ok: torch.Tensor
    slot: torch.Tensor
    cap: int

    def dropped(self) -> torch.Tensor:
        """``[N, k]`` bool: the (token, k) entries over capacity."""
        out = torch.empty_like(self.ok)
        out[self.order] = ~self.ok
        return out.reshape(self.eids.shape)


def moe_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ``ceil(N k / E x capacity_factor)`` rounded up
    to a multiple of 8, at least 8 (the reference's, in Python floats)."""
    m = cfg.moe
    cap = int(math.ceil(n_tokens * m.top_k / m.num_experts
                        * m.capacity_factor))
    return max(8, -(-cap // 8) * 8)


def moe_route(p: dict, xt: torch.Tensor, cfg: ModelConfig) -> MoERoute:
    """The router and the dispatch plan of ``_moe_dense`` for tokens
    ``xt`` ``[N, d]``: router logits and softmax in f32; top-k by a
    stable descending sort, so equal probabilities pick the lower expert
    id as ``lax.top_k`` does (``torch.topk`` promises no tie order); the
    Switch-style aux loss; then the group-by-destination of TAM's request
    bucketing: entries sorted stably by expert, their position within
    the expert from an exclusive prefix sum of the counts, and entries at
    or past ``cap`` dropped (they keep the first ``cap`` of each expert in
    flattened (token, k) order)."""
    m = cfg.moe
    n = xt.shape[0]
    e, k = m.num_experts, m.top_k
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)        # [N, E]
    gates, eids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eids = gates[:, :k], eids[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # load-balancing aux loss (Switch-style)
    me = probs.mean(dim=0)
    ce = torch.zeros(e, dtype=torch.float32, device=xt.device).index_add_(
        0, eids.reshape(-1), torch.full((n * k,), 1.0 / (n * k),
                                        dtype=torch.float32,
                                        device=xt.device))
    aux = e * torch.sum(me * ce)

    cap = moe_capacity(n, cfg)
    flat_e = eids.reshape(-1)                                      # [N*k]
    ranked, order = torch.sort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n * k, device=xt.device) - starts[ranked]
    ok = pos < cap
    slot = torch.where(ok, ranked * cap + pos, e * cap)
    return MoERoute(gates, eids, aux, order, ok, slot, cap)


def moe(p: dict, x: torch.Tensor, cfg: ModelConfig, plan=None):
    """Top-k MoE -> ``(out, aux)``. With a mesh'd ``plan``: the
    explicitly partitioned GShard dispatch of ``moe_sharded.py`` on the
    emulated ranks; without one: the dense sort-based dispatch."""
    if plan is not None and plan.mesh is not None:
        return moe_sharded(p, x, cfg, plan)
    return _moe_dense(p, x, cfg)


def _moe_dense(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Sort-based top-k MoE with capacity dropping (the reference's
    single-device path): the routing of :func:`moe_route`, each kept
    entry's token row written to its expert's slot of an ``[E, cap, d]``
    buffer, the experts' SwiGLU as three batched products, and each
    token's k outputs gathered back and weighted by its gates. The
    reference writes dropped entries out of bounds with ``mode="drop"``;
    here they go to a spare last row that is sliced off, so nothing is
    written out of bounds and the card needs no host sync. Returns
    ``(out, aux)``."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    n = b * s
    xt = x.reshape(n, d)
    r = moe_route(p, xt, cfg)
    cap = r.cap
    rows = xt[r.order // k]                                     # [N*k, d]
    disp = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    disp[r.slot] = rows
    disp = disp[:e * cap].reshape(e, cap, d)
    h = torch.einsum("ecd,edf->ecf", disp, p["wi"])
    g = torch.einsum("ecd,edf->ecf", disp, p["wg"])
    eo = torch.einsum("ecf,efd->ecd", F.silu(g) * h, p["wo"])
    # combine: gather each token's k expert outputs, weight by the gates
    inv_slot = torch.empty_like(r.slot)
    inv_slot[r.order] = r.slot
    eo_pad = torch.cat([eo.reshape(e * cap, d),
                        torch.zeros((1, d), dtype=eo.dtype,
                                    device=eo.device)])
    per_tok = eo_pad[inv_slot].reshape(n, k, d)
    out = (per_tok * r.gates[..., None].to(per_tok.dtype)).sum(dim=1)
    return out.reshape(b, s, d), r.aux


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
               lead: tuple = ()) -> dict:
    """Split projections (``wx``, ``wz``, ``wbcdt``), the depthwise conv,
    f32 ``A_log`` (zeros), ``D`` (ones), ``dt_bias`` and ``norm`` (zeros),
    and ``out_proj``, as the reference's ``init_mamba``."""
    mc = cfg.mamba
    d = cfg.d_model
    di, ds, nh = mc.d_inner(d), mc.d_state, mc.n_heads(d)
    sc = 1.0 / math.sqrt(d)

    def const(n, value):
        return torch.full((*lead, n), value, dtype=torch.float32,
                          device=gen.device)
    return {
        "wx": _normal(gen, (*lead, d, di), dtype, sc),
        "wz": _normal(gen, (*lead, d, di), dtype, sc),
        "wbcdt": _normal(gen, (*lead, d, 2 * ds + nh), dtype, sc),
        "conv": _normal(gen, (*lead, mc.d_conv, di + 2 * ds), dtype, 0.1),
        "A_log": const(nh, 0.0),
        "D": const(nh, 1.0),
        "dt_bias": const(nh, 0.0),
        "norm": const(di, 0.0),
        "out_proj": _normal(gen, (*lead, di, d), dtype, 1.0 / math.sqrt(di)),
    }


def _ssd_chunked(xh, dt, A, B_, C_, chunk: int):
    """SSD (state-space duality) forward, chunked, in f32.

    xh: [B, S, nh, hd]; dt: [B, S, nh]; A: [nh] (negative); B_, C_:
    [B, S, ds]. Returns (y [B, S, nh, hd], final state [B, nh, ds, hd]).
    The reference scans the chunk states with ``lax.scan``; a Python loop
    over the chunks gives each chunk the state before it."""
    b, s, nh, hd = xh.shape
    ds = B_.shape[-1]
    nc = s // chunk
    xc = xh.reshape(b, nc, chunk, nh, hd).float()
    dtc = dt.reshape(b, nc, chunk, nh)
    Bc = B_.reshape(b, nc, chunk, ds)
    Cc = C_.reshape(b, nc, chunk, ds)
    a = dtc * A[None, None, None, :]                    # [b,nc,L,nh] (<=0)
    cum = torch.cumsum(a, dim=2)                        # within-chunk

    # intra-chunk (masked "attention" in log space). exp of -inf where
    # i < j: the reference's where(causal, exp(seg), 0), whose masked
    # exp may overflow, which autograd would turn into NaN gradients
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [b,nc,Li,Lj,nh]
    il = torch.arange(chunk, device=xh.device)
    causal = (il[:, None] >= il[None, :])[None, None, :, :, None]
    decay = torch.exp(torch.where(causal, seg, -torch.inf))
    del seg
    cb = torch.einsum("bnis,bnjs->bnij", Cc, Bc)        # [b,nc,Li,Lj]
    m = decay * cb[..., None] * dtc[:, :, None, :, :]   # [b,nc,Li,Lj,nh]
    del decay
    y_intra = torch.einsum("bnijh,bnjhd->bnihd", m, xc)
    del m

    # chunk states: S_n = sum_j exp(cum_last - cum_j) dt_j B_j x_j
    last = cum[:, :, -1:, :]                            # [b,nc,1,nh]
    w = torch.exp(last - cum) * dtc                     # [b,nc,L,nh]
    states = torch.einsum("bnlh,bnls,bnlhd->bnhsd", w, Bc, xc)
    chunk_decay = torch.exp(last[:, :, 0, :])           # [b,nc,nh]

    st = torch.zeros((b, nh, ds, hd), dtype=torch.float32, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(st)                                 # the state before
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)              # [b,nc,nh,ds,hd]

    # inter-chunk: y_i += C_i . (exp(cum_i) * prev_state)
    y_inter = torch.einsum("bnls,bnlh,bnhsd->bnlhd", Cc, torch.exp(cum),
                           prev_states)
    y = (y_intra + y_inter).reshape(b, s, nh, hd)
    return y, st


def _depthwise_conv(window: torch.Tensor, w: torch.Tensor, s: int):
    """The causal depthwise conv of the reference: a Python sum over the
    taps, ``window`` holding ``d_conv - 1`` earlier positions before the
    ``s`` new ones."""
    return sum(window[:, i:i + s] * w[i][None, None, :]
               for i in range(w.shape[0]))


def mamba_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                state: tuple | None = None):
    """Mamba2 SSD block. ``state=(ssm_state [B, nh, ds, hd] f32,
    conv_state [B, d_conv - 1, di + 2 ds])`` runs single-token decode;
    None the full sequence, which must divide into SSD chunks (a
    ``ValueError`` otherwise: the reference asserts it). Returns
    ``(out, new_state)``; the full sequence's new state is the handoff to
    decode (the final SSM state and the conv tail, zero-padded in front
    for a prompt shorter than ``d_conv - 1``)."""
    mc = cfg.mamba
    b, s, d = x.shape
    di, ds, nh = mc.d_inner(d), mc.d_state, mc.n_heads(d)
    hd = mc.head_dim
    xin = torch.einsum("bsd,de->bse", x, p["wx"])
    z = torch.einsum("bsd,de->bse", x, p["wz"])
    bcdt = torch.einsum("bsd,de->bse", x, p["wbcdt"])
    B_, C_, dt = torch.split(bcdt, [ds, ds, nh], dim=-1)
    conv_in = torch.cat([xin, B_, C_], dim=-1)           # [b,s,di+2ds]
    dt_s = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if state is None:
        chunk = min(mc.chunk, s)
        if s % chunk:
            raise ValueError(f"seq {s} must divide into SSD chunks of "
                             f"{mc.chunk}")
        pad = F.pad(conv_in, (0, 0, mc.d_conv - 1, 0))
        conv = F.silu(_depthwise_conv(pad, p["conv"], s))
        xin, B_, C_ = torch.split(conv, [di, ds, ds], dim=-1)
        xh = xin.reshape(b, s, nh, hd)
        y, final_ssm = _ssd_chunked(xh, dt_s, A, B_.float(), C_.float(),
                                    chunk)
        y = y + p["D"][None, None, :, None] * xh.float()
        # state handoff for prefill -> decode continuation
        tail = conv_in[:, s - (mc.d_conv - 1):] if s >= mc.d_conv - 1 \
            else F.pad(conv_in, (0, 0, mc.d_conv - 1 - s, 0))
        new_state = (final_ssm, tail)
    else:
        ssm_state, conv_state = state                   # decode: s == 1
        window = torch.cat([conv_state, conv_in], dim=1)
        conv = F.silu(_depthwise_conv(window, p["conv"], 1))
        xin, B_, C_ = torch.split(conv, [di, ds, ds], dim=-1)
        xh = xin.reshape(b, 1, nh, hd).float()
        dec = torch.exp(dt_s[:, 0, :] * A[None, :])     # [b,nh]
        upd = torch.einsum("bh,bs,bhd->bhsd", dt_s[:, 0, :],
                           B_[:, 0].float(), xh[:, 0])
        ssm_state = ssm_state * dec[..., None, None] + upd
        y = torch.einsum("bs,bhsd->bhd", C_[:, 0].float(),
                         ssm_state)[:, None]
        y = y + p["D"][None, None, :, None] * xh
        new_state = (ssm_state, window[:, 1:])
    y = y.reshape(b, s, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return torch.einsum("bse,ed->bsd", y, p["out_proj"]), new_state
