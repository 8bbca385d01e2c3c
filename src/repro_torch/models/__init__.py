"""Model zoo of the port: config schema, shared layers, and the models
assembled in ``transformer.py`` from GQA attention blocks with dense FFNs
and from Mamba-2 SSD blocks (``ssm.py``).  The other mixers of the
reference package (MLA, MoE, RG-LRU) wait for later slices (ROADMAP.md,
queue A item 9).
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
from repro_torch.models.ssm import SSMCache
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
    "SSMCache",
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
