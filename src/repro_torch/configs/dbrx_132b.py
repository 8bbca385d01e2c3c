"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16 experts top-4 (fine-grained).
[hf:databricks/dbrx-base; unverified]
"""

from repro_torch.models.config import BlockSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab=100352,
    pattern=(BlockSpec(mixer="attn", ffn="moe"),),
    n_periods=40,
    act="silu",
    rope_theta=5e5,
    moe=MoEConfig(
        n_experts=16,
        top_k=4,
        d_expert=10752,
        n_shared=0,
        normalize_top_k=True,
        capacity_factor=1.25,
    ),
)
