"""Optimizer of the training path: AdamW with a cosine schedule and
global-norm clipping (``adamw.py``), and int8 gradient compression with
error feedback (``compression.py``), over the port's trees of tensors."""

from repro_torch.optim.adamw import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
)
from repro_torch.optim.compression import EFState, compress_decompress, ef_init

__all__ = [
    "AdamWConfig",
    "OptState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_schedule",
    "global_norm",
    "EFState",
    "compress_decompress",
    "ef_init",
]
