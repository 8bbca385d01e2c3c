"""qwen2.5-3b [dense] — 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936; QKV bias.  [hf:Qwen/Qwen2.5-0.5B family; hf]
"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab=151936,
    pattern=(BlockSpec(mixer="attn", ffn="dense"),),
    n_periods=36,
    act="silu",
    qkv_bias=True,
    rope_theta=1e6,
)
