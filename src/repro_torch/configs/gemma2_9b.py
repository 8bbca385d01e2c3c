"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) head_dim=256
d_ff=14336 vocab=256000; local(4096)+global alternating, logit softcaps,
pre+post sandwich norms.  [arXiv:2408.00118; hf]
"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    pattern=(
        BlockSpec(mixer="local", ffn="dense", window=4096),
        BlockSpec(mixer="attn", ffn="dense"),
    ),
    n_periods=21,
    act="gelu",
    rms_plus_one=True,
    embed_scale=True,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_block_norm=True,
)
