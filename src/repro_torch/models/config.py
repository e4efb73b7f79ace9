"""Model configuration for the 10-arch zoo (a copy of the reference's
``models/config.py``, which is plain dataclasses).

One dataclass covers every family (dense / moe / ssm / hybrid / enc-dec /
audio / vlm); family-specific fields are None/0 when unused. All configs
are instantiated in ``repro_torch.configs.<arch>`` with the exact numbers
from the assignment table.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Literal


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    every_n: int = 1          # MoE FFN on layers with (i % every_n == every_n-1)
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256          # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None        # default d_model // n_heads
    rope_theta: float = 1e4
    qkv_bias: bool = False
    # gemma2-style features
    window: int | None = None          # sliding window for local layers
    local_global_alternate: bool = False
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    # moe / hybrid
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    attn_every: int = 1                # hybrid: attention on layers i%attn_every==0
    # enc-dec (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500                # whisper frame count after conv stub
    # modality frontend stub: inputs are precomputed embeddings
    frontend: Literal["none", "audio", "vision"] = "none"
    num_prefix_embeds: int = 0         # vlm: image patch embeddings prepended
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the embedding tables are
        TP-shardable on any mesh up to 256-way; logits are sliced back to
        ``vocab`` before the loss."""
        return -(-self.vocab // 256) * 256

    @property
    def block_period(self) -> int:
        """Layers per scanned super-block (lcm of structural periods)."""
        p = 1
        if self.local_global_alternate:
            p = 2
        if self.attn_every > 1:
            p = _lcm(p, self.attn_every)
        if self.moe and self.moe.every_n > 1:
            p = _lcm(p, self.moe.every_n)
        return p

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_every > 1:
            return i % self.attn_every == 0
        return True

    def is_local_layer(self, i: int) -> bool:
        return bool(self.local_global_alternate) and i % 2 == 0

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        return i % self.moe.every_n == self.moe.every_n - 1

    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM/hybrid; see DESIGN.md §5)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, h = self.d_model, self.head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            if self.is_attn_layer(i):
                total += d * h * (n_q + 2 * n_kv) + n_q * h * d
            elif self.mamba:
                di = self.mamba.d_inner(d)
                nh = self.mamba.n_heads(d)
                ds = self.mamba.d_state
                # in_proj -> [z, x, B, C, dt]; conv over (x, B, C); out_proj
                total += d * (2 * di + 2 * ds + nh)
                total += (di + 2 * ds) * self.mamba.d_conv
                total += di * d
                total += 3 * nh + di                                # A, D, dt_bias, norm
            if self.is_moe_layer(i):
                total += self.moe.num_experts * 3 * d * self.moe.d_ff_expert
                total += d * self.moe.num_experts                   # router
            elif self.d_ff:
                total += 3 * d * self.d_ff
            total += 2 * d                                          # norms
        if self.enc_dec:
            for _ in range(self.n_enc_layers):
                total += d * h * (n_q + 2 * n_kv) + n_q * h * d + 3 * d * self.d_ff
                total += d * h * (n_q + 2 * n_kv) + n_q * h * d     # cross-attn
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE counts top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        n_moe = sum(self.is_moe_layer(i) for i in range(self.n_layers))
        all_exp = n_moe * self.moe.num_experts * 3 * self.d_model * self.moe.d_ff_expert
        act_exp = n_moe * self.moe.top_k * 3 * self.d_model * self.moe.d_ff_expert
        return full - all_exp + act_exp


def _lcm(a: int, b: int) -> int:
    import math
    return a * b // math.gcd(a, b)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    small = dict(
        n_layers=max(cfg.block_period, 2) if cfg.block_period > 1 else 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        head_dim=16,
        enc_seq=8 if cfg.enc_dec else cfg.enc_seq,
        num_prefix_embeds=4 if cfg.frontend == "vision" else 0,
    )
    if cfg.moe:
        # generous capacity so smoke tests are drop-free (drops make
        # teacher-forced decode legitimately differ from full forward)
        small["moe"] = replace(cfg.moe, num_experts=4,
                               top_k=min(cfg.moe.top_k, 2), d_ff_expert=64,
                               capacity_factor=4.0)
    if cfg.mamba:
        small["mamba"] = replace(cfg.mamba, d_state=16, head_dim=16, chunk=8)
    if cfg.enc_dec:
        small["n_enc_layers"] = 2
    small.update(overrides)
    return replace(cfg, name=cfg.name + "-smoke", **small)
