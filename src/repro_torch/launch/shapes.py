"""Shape cells: the assigned (arch x input-shape) grid (a copy of the
reference's ``launch/shapes.py``, which imports no JAX).

LM shapes are seq_len x global_batch. ``decode_*`` / ``long_*`` are one
token against a seq_len KV cache; ``prefill_*`` is the cache-building
forward; ``train_*`` is the full forward + backward + optimizer step.
long_500k runs only for sub-quadratic archs (SSM/hybrid).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch import configs
from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    global_batch: int


SHAPES = (
    ShapeCell("train_4k", "train", 4096, 256),
    ShapeCell("prefill_32k", "prefill", 32768, 32),
    ShapeCell("decode_32k", "decode", 32768, 128),
    ShapeCell("long_500k", "decode", 524288, 1),
)

# archs where Adafactor replaces AdamW (>=400B params — bf16 AdamW
# moments alone would exceed the fleet HBM; see optim.optimizers).
ADAFACTOR_ARCHS = frozenset({"kimi_k2", "llama4_maverick",
                             "jamba_15_large"})


def shape(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def applicable(cfg: ModelConfig, cell: ShapeCell) -> bool:
    if cell.name == "long_500k":
        return cfg.sub_quadratic()
    return True


def all_cells(include_skipped: bool = False):
    """Yield (arch_id, ShapeCell[, skipped]) for the 40-cell grid."""
    for arch in configs.ARCHS:
        cfg = configs.get(arch)
        for cell in SHAPES:
            ok = applicable(cfg, cell)
            if include_skipped:
                yield arch, cell, not ok
            elif ok:
                yield arch, cell
