"""Sharding plan: maps model tensors onto the production mesh (the port
of the reference's ``models/sharding.py``).

Axes (see ``launch/mesh.py``): single-pod ``(data=16, model=16)``;
multi-pod ``(pod=2, data=16, model=16)``. DP over (pod, data); TP/EP/SP
over model.

The plan is expressed as partition specs (the port's :class:`P`, entry
for entry the reference's ``PartitionSpec``). The reference applies them
with ``with_sharding_constraint``; the port runs on one device, where
:meth:`ShardingPlan.constrain` is the identity. A plan with a mesh (an
emulated one, ``compat.EmulatedMesh``) sends the MoE and the decode
attention through their rank-axis forms (``models/moe_sharded.py``,
``layers.decode_attention_sharded``), as the reference's shard_map
bodies.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from repro_torch.compat import P


@dataclass(frozen=True)
class ShardingPlan:
    mesh: Any = None                         # compat.EmulatedMesh or None
    data_axes: tuple[str, ...] = ("data",)   # ("pod","data") multi-pod
    model_axis: str = "model"
    # Megatron-style sequence parallelism: residual-stream activations
    # are sharded over the model axis on the SEQ dim between layers. Off
    # for decode, where seq is 1.
    shard_seq: bool = True
    # Activation-TP (True: heads/ffn activations sharded over model) vs
    # fully sequence-sharded compute (False: activations stay
    # SEQ-sharded through attention and FFN).
    activation_tp: bool = True

    @property
    def dp(self):
        if not self.data_axes:
            return None          # batch too small to shard (e.g. gb=1)
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    @property
    def tp(self):
        return self.model_axis

    # ---- parameter specs ---------------------------------------------
    def embed(self) -> P:          # [vocab, d]
        return P(self.tp, None)

    def attn_qkv(self) -> P:       # [d, H, head_dim]
        return P(None, self.tp, None)

    def attn_o(self) -> P:         # [H, head_dim, d]
        return P(self.tp, None, None)

    def mlp_in(self) -> P:         # [d, f]
        return P(None, self.tp)

    def mlp_out(self) -> P:        # [f, d]
        return P(self.tp, None)

    def moe_in(self) -> P:         # [E, d, f] — expert parallel
        return P(self.tp, None, None)

    def moe_out(self) -> P:        # [E, f, d]
        return P(self.tp, None, None)

    def vector(self) -> P:         # norms etc.
        return P(None)

    # ---- activation specs --------------------------------------------
    def act(self) -> P:            # [B, S, d] residual stream
        if self.shard_seq:
            return P(self.dp, self.tp, None)
        return P(self.dp, None, None)

    def act_heads(self) -> P:      # [B, S, H, head_dim]
        if not self.activation_tp and self.shard_seq:
            return P(self.dp, self.tp, None, None)   # seq-sharded attn
        return P(self.dp, None, self.tp, None)

    def kv_full(self) -> P:        # [B, S, Hkv, hd] K/V during attention
        # seq-replicated so a seq-sharded Q attends to the whole context
        return P(self.dp, None, None, None)

    def act_ff(self) -> P:         # [B, S, f]
        if not self.activation_tp and self.shard_seq:
            return P(self.dp, self.tp, None)
        return P(self.dp, None, self.tp)

    def logits(self) -> P:         # [B, S, V]
        if not self.activation_tp and self.shard_seq:
            return P(self.dp, self.tp, None)
        return P(self.dp, None, self.tp)

    def tokens(self) -> P:         # [B, S]
        return P(self.dp, None)

    def kv_cache(self) -> P:       # [B, S, Hkv, head_dim] — SP over seq
        return P(self.dp, self.tp, None, None)

    def ssm_state(self) -> P:      # [B, nh, head_dim, d_state]
        return P(self.dp, self.tp, None, None)

    def moe_dispatch(self) -> P:   # [E, cap, d] — EP x DP
        return P(self.tp, self.dp, None)

    def flat_tokens(self) -> P:    # [N(*k), ...] — sharded over EVERYTHING
        axes = tuple(self.data_axes) + (self.model_axis,)
        return P(axes, None)

    def flat_tokens_1d(self) -> P:
        axes = tuple(self.data_axes) + (self.model_axis,)
        return P(axes)

    def constrain(self, x, spec: P):
        """The identity: one device holds every rank's data (the
        reference's ``with_sharding_constraint`` places it)."""
        return x


def unsharded() -> ShardingPlan:
    """Plan with no mesh: every constraint is the identity and every
    layer takes its single-device path."""
    return ShardingPlan(mesh=None)
