"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified]."""
from repro_torch.models.config import ModelConfig, MambaConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, head_dim=64,
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      chunk=256),
)
