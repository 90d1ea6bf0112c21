"""Assigned input-shape set for the LM-family architectures (a copy of
repro.configs.shapes).

Each shape names the step it lowers:
  train_4k    -> train_step   (seq 4,096  x global_batch 256)
  prefill_32k -> serve_prefill (seq 32,768 x global_batch 32)
  decode_32k  -> serve_decode  (one new token, KV cache of 32,768, batch 128)
  long_500k   -> serve_decode  (one new token, context 524,288, batch 1) —
                 sub-quadratic archs only (ssm/hybrid); skipped for pure
                 full-attention archs per the assignment (see DESIGN.md).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    step: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = (
    ShapeSpec("train_4k", "train", 4_096, 256),
    ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    ShapeSpec("decode_32k", "decode", 32_768, 128),
    ShapeSpec("long_500k", "decode", 524_288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason). Encodes the assignment's skip rules."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.name} is pure full-attention (skip per assignment)"
        )
    return True, ""


def cells(cfg: ModelConfig):
    """All (shape, runnable, reason) cells for one arch."""
    return [(s, *applicable(cfg, s)) for s in SHAPES]
