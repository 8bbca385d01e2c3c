"""Assigned input-shape cells + per-arch applicability and memory knobs.

Shape semantics (per the brief):
  * train_4k / prefill_32k lower the full-sequence step,
  * decode_32k / long_500k lower ``serve_step`` (one token, KV cache of
    seq_len) — skipped for encoder-only archs (no decode),
  * long_500k needs sub-quadratic attention — only SSM/hybrid archs run it.

``microbatches`` and chunk sizes are the per-cell activation-memory knobs
(DESIGN.md §4); values here are the tuned baselines from §Perf.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, Optional

from repro_torch.models.config import ModelConfig, ShapeConfig

__all__ = ["SHAPES", "shapes_for", "skip_reason"]

SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig(
        name="train_4k", kind="train", seq_len=4096, global_batch=256,
        microbatches=8, q_chunk=512, kv_chunk=1024, loss_chunk=512,
        remat="full",
    ),
    "prefill_32k": ShapeConfig(
        name="prefill_32k", kind="prefill", seq_len=32768, global_batch=32,
        q_chunk=512, kv_chunk=2048, loss_chunk=512, remat="full",
    ),
    "decode_32k": ShapeConfig(
        name="decode_32k", kind="decode", seq_len=32768, global_batch=128,
        remat="none",
    ),
    "long_500k": ShapeConfig(
        name="long_500k", kind="decode", seq_len=524288, global_batch=1,
        remat="none",
    ),
}

#: archs with O(seq) or O(window) decode state (may run long_500k)
SUBQUADRATIC = {"mamba2-2.7b", "recurrentgemma-9b"}
ENCODER_ONLY = {"hubert-xlarge"}


def skip_reason(cfg: ModelConfig, shape_name: str) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the documented skip."""
    if cfg.name in ENCODER_ONLY and SHAPES[shape_name].kind == "decode":
        return "encoder-only: no decode step"
    if shape_name == "long_500k" and cfg.name not in SUBQUADRATIC:
        return "full attention is quadratic at 512k; skipped per brief"
    return None


#: per-(arch, shape) knob overrides — tuned so compiled memory fits 16 GB/chip
_OVERRIDES: Dict[tuple, dict] = {
    # NOTE: microbatch count must keep B_mb divisible by pod*data (=32
    # multi-pod), so 8 is the deepest slicing for global_batch=256.
    ("dbrx-132b", "train_4k"): {"microbatches": 8},
    ("qwen1.5-32b", "train_4k"): {"microbatches": 8},
    ("internvl2-26b", "train_4k"): {"microbatches": 8},
    ("mamba2-2.7b", "train_4k"): {"microbatches": 4},
    ("gemma-2b", "train_4k"): {"microbatches": 4},
}


#: §Perf-winning variant per cell kind (see EXPERIMENTS.md §Perf); applied
#: via ``dryrun --variant`` / ``hillclimb``.  Baselines stay paper-faithful.
BEST_VARIANTS: Dict[tuple, str] = {
    ("qwen1.5-32b", "prefill_32k"): "pad-heads+tp8",
    ("gemma-2b", "prefill_32k"): "pad-heads",
    ("qwen2.5-3b", "train_4k"): "zero1+tp2+mb2",
    ("deepseek-v2-lite-16b", "train_4k"): "zero1+tp8",
    # all dense decode cells: inference weights TP-only
    ("*", "decode_32k"): "no-fsdp",
}


def shapes_for(cfg: ModelConfig) -> Dict[str, ShapeConfig]:
    """Runnable shape cells for an arch, with per-cell knob overrides."""
    out = {}
    for name, sh in SHAPES.items():
        if skip_reason(cfg, name) is not None:
            continue
        ov = _OVERRIDES.get((cfg.name, name))
        out[name] = replace(sh, **ov) if ov else sh
    return out
