"""PyTorch/CUDA port of the TAM collective-I/O reproduction.

``repro_torch`` mirrors ``repro``'s layering (``core`` planner, routing
and round engine; ``kernels`` with hand-written Hopper kernels) and
imports neither JAX nor ``repro``. Its entry points run on the card
unless the caller passes ``device="cpu"``.
"""
