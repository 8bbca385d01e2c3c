"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) head_dim=256
d_ff=16384 vocab=256000; GeGLU.  [arXiv:2403.08295; hf]

8 heads < TP=16, so attention TP lands on head_dim (DESIGN.md §4) — this
arch is a candidate for the collective-bound hillclimb.
"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    pattern=(BlockSpec(mixer="attn", ffn="dense"),),
    n_periods=18,
    act="gelu",
    rms_plus_one=True,
    embed_scale=True,
)
