"""llava-next-34b [vlm] — yi-34b backbone, anyres tiling; vision
frontend STUB (input_specs provides precomputed patch embeddings)
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, rope_theta=5e6,
    frontend="vision", num_prefix_embeds=576,  # one anyres tile stub
)
