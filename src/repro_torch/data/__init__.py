"""Synthetic token data of the training path (port of ``repro.data``)."""
from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig, SyntheticTokenPipeline, make_batch_iterator,
)
