"""Model zoo of the port: config schema, shared layers, and the models
assembled in ``transformer.py`` from the reference package's mixers (GQA
attention, multi-head latent attention ``mla.py``, Mamba-2 SSD ``ssm.py``,
RG-LRU ``rglru.py``) and FFNs (dense, mixture of experts ``moe.py``):
every configuration of ``repro_torch.configs``.
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
from repro_torch.models import attention, mla, moe, rglru, ssm
from repro_torch.models.convert import from_jax_params
from repro_torch.models.ctx import ShardCtx, constrain
from repro_torch.models.mla import MLACache
from repro_torch.models.param import ParamDef, init_params, stack_defs
from repro_torch.models.rglru import RGLRUCache
from repro_torch.models.ssm import SSMCache
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_cache,
    logits_fn,
    model_defs,
    shard_moe_params,
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
    "MLACache",
    "RGLRUCache",
    "attention",
    "mla",
    "moe",
    "rglru",
    "ssm",
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
    "shard_moe_params",
    "ShardCtx",
    "constrain",
]
