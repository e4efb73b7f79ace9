"""kimi-k2-1t-a32b [moe] — trillion-param MoE 384e top-8
[arXiv:2501.kimi2; unverified]."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=0, vocab=163840, rope_theta=5e4,
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048, every_n=1),
)
