"""recurrentgemma-9b [hybrid] — 38 blocks d_model=4096, RG-LRU + local
attention 1:2 (pattern R,R,L), 16H MQA kv=1 head_dim=256, d_ff=12288,
lru_width=4096, window=2048, vocab=256000.  [arXiv:2402.19427; unverified]

Runs long_500k: RG-LRU state + 2048-slot ring cache are O(1)/O(window).
38 = 12×(R,R,L) + 2 trailing recurrent blocks (postlude).
"""

from repro_torch.models.config import BlockSpec, ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    pattern=(
        BlockSpec(mixer="rglru", ffn="dense"),
        BlockSpec(mixer="rglru", ffn="dense"),
        BlockSpec(mixer="local", ffn="dense", window=2048),
    ),
    n_periods=12,
    postlude=(
        BlockSpec(mixer="rglru", ffn="dense"),
        BlockSpec(mixer="rglru", ffn="dense"),
    ),
    act="gelu",
    rms_plus_one=True,
    embed_scale=True,
    rglru=RGLRUConfig(lru_width=4096, d_conv=4),
)
