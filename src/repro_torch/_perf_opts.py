"""The reference's ``REPRO_PERF_OPTS`` setting, below the kernels and the
models.

``src/repro/models/layers.py::perf_opts_enabled`` reads the environment
at every call. On (the default, ``REPRO_PERF_OPTS`` unset or ``"1"``),
the model's attention takes its keys 4096 at a time and rounds the
probabilities and values to bf16 for the p.v product; off (any other
value), it takes them 1024 at a time and keeps p.v in f32, which is
also what the TPU kernel (``src/repro/kernels/flash.py``) computes.
``kernels.ref``'s plain attention and ``kernels.ops.fused_attention``
read it here (``flash_attention_ref`` where its ``pv32`` is None), and
``models.layers`` exports it under the reference's name; the kernels
and the models of their arithmetic take the choice as an argument
(``pv32``, default False).
"""
from __future__ import annotations

import os


def perf_opts_enabled() -> bool:
    """Whether ``REPRO_PERF_OPTS`` is on, read now (as the reference)."""
    return os.environ.get("REPRO_PERF_OPTS", "1") == "1"

