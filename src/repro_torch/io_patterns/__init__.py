"""Request patterns of the paper's benchmarks, as write-executor inputs."""
from repro_torch.io_patterns.generators import (  # noqa: F401
    btio_pattern, e3sm_f_pattern, e3sm_g_pattern, s3d_pattern,
    sparse_checkpoint_pattern,
)
