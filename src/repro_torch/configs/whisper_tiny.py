"""whisper-tiny [audio] — enc-dec, conv frontend STUB (input_specs
provides precomputed frame embeddings) [arXiv:2212.04356; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, rope_theta=1e4,
    enc_dec=True, n_enc_layers=4, enc_seq=1500, frontend="audio",
)
