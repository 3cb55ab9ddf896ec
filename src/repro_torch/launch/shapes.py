"""The assigned input-shape set (one per arch x shape cell), a copy of the
JAX package's ``launch/shapes.py``.

  train_4k      seq 4,096   global_batch 256   -> train_step
  prefill_32k   seq 32,768  global_batch 32    -> serve prefill
  decode_32k    seq 32,768  global_batch 128   -> serve_step (1 new token,
                                                  KV cache of seq_len)
  long_500k     seq 524,288 global_batch 1     -> serve_step; SSM/hybrid only

``long_500k`` is skipped for pure full-attention archs; all archs are
decoder-style so decode shapes apply.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic():
        return False, ("long_500k requires sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention (skip per "
                       "assignment, noted in DESIGN.md)")
    return True, ""


def cells(configs: dict[str, ModelConfig]) -> list[tuple[str, str]]:
    """All runnable (arch, shape) cells."""
    out = []
    for arch, cfg in configs.items():
        for sname, sh in SHAPES.items():
            ok, _ = applicable(cfg, sh)
            if ok:
                out.append((arch, sname))
    return out
