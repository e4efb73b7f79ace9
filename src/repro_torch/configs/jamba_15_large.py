"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e
top-2 every other layer [arXiv:2403.19887; hf]."""
from repro_torch.models.config import ModelConfig, MoEConfig, MambaConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536, rope_theta=1e4,
    attn_every=8,  # layer i%8==0 is attention, 7 mamba layers follow
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576, every_n=2),
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      chunk=256),
)
