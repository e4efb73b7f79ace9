"""gemma2-9b [dense] — local+global alternating, logit softcaps
[arXiv:2408.00118; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
    d_ff=14336, vocab=256000, head_dim=256, rope_theta=1e4,
    window=4096, local_global_alternate=True,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    tie_embeddings=True,
)
