"""llama4-maverick-400b-a17b [moe] — MoE 128e top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=0, vocab=202048, rope_theta=5e5,
    moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192, every_n=1),
)
