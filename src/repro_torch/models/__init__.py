"""Model zoo of the port: config schema, shared layers, and the dense
attention transformer (GQA attention blocks with dense FFNs) assembled in
``transformer.py``.  The other mixers of the reference package (MLA, MoE,
Mamba-2 SSD, RG-LRU) wait for later slices (ROADMAP.md, queue A item 9).
"""

from repro_torch.models.config import (
    BlockSpec,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    RGLRUConfig,
    SSMConfig,
    ShapeConfig,
    reduced_for_smoke,
)
from repro_torch.models.convert import from_jax_params
from repro_torch.models.param import ParamDef, init_params, stack_defs
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_cache,
    logits_fn,
    model_defs,
)

__all__ = [
    "BlockSpec",
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "RGLRUConfig",
    "SSMConfig",
    "ShapeConfig",
    "reduced_for_smoke",
    "from_jax_params",
    "ParamDef",
    "init_params",
    "stack_defs",
    "decode_step",
    "forward",
    "init_cache",
    "logits_fn",
    "model_defs",
]
