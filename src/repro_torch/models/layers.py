"""Model building blocks of the dense LM: norms, RoPE, softcap,
attention and the SwiGLU MLP (the port of the dense part of the
reference's ``models/layers.py``).

Pure functions over explicit parameter dicts, as in the reference. The
reference threads a ``ShardingPlan`` through every layer; on one device
its ``constrain`` is the identity and its sharded decode
(``decode_attention_sharded``) does not apply, so the port has neither.
Attention on a CUDA tensor runs the Hopper kernel through
``kernels.ops.fused_attention`` (and, where an input requires grad, its
backward kernel in the backward pass); on a CPU tensor it runs the plain
version, ``kernels.ref.flash_attention_ref``, which autograd
differentiates. The dense matrix products
are ``torch.einsum`` calls, as the reference leaves them to XLA.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models.config import ModelConfig

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


def _proj_heads(x, w, b, n_heads: int, hd: int):
    b_, s_, _ = x.shape
    y = torch.einsum("bsd,de->bse", x, w)
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


def attention(p: dict, x: torch.Tensor, cfg: ModelConfig, positions, *,
              local: bool, cache: tuple | None = None,
              cache_pos: int | None = None):
    """Full attention sub-layer.

    Modes:
      prefill: cache None -> causal flash attention over x itself.
        Returns (out, (k, v)) so prefill can build the cache.
      decode: cache=(k_cache, v_cache) [B, S_max, Hkv, hd], cache_pos =
        the write position (an int). x is [B, 1, d]. The new keys and
        values are written into the caches IN PLACE (the reference's
        ``dynamic_update_slice`` returns new arrays); the caches returned
        are the ones passed in.
    """
    window = cfg.window if local else None
    q, k, v = _qkv(p, x, cfg, positions)
    if cache is None:
        out = flash_attention(q, k, v, causal=True, window=window,
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
        out = flash_attention(q, k_cache, v_cache, causal=False,
                              window=window,
                              logit_cap=cfg.attn_logit_softcap,
                              q_offset=cache_pos, kv_len=cache_pos + 1)
        new_cache = (k_cache, v_cache)
    out = out.reshape(*out.shape[:2], -1)
    return torch.einsum("bse,ed->bsd", out, p["wo"]), new_cache


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
    h = torch.einsum("bsd,df->bsf", x, p["wi"])
    g = torch.einsum("bsd,df->bsf", x, p["wg"])
    return torch.einsum("bsf,fd->bsd", F.silu(g) * h, p["wo"])
