"""qwen1.5-32b [dense] — 64L d_model=5120 40H (MHA kv=40) d_ff=27392
vocab=152064; QKV bias.  [hf:Qwen/Qwen1.5 family; hf]

40 heads % TP(16) != 0, so attention TP lands on head_dim (DESIGN.md §4).
"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab=152064,
    pattern=(BlockSpec(mixer="attn", ffn="dense"),),
    n_periods=64,
    act="silu",
    qkv_bias=True,
)
