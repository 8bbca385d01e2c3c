"""internvl2-26b [vlm] — InternLM2-20B language backbone: 48L d_model=6144
48H (GQA kv=8) d_ff=16384 vocab=92553.  [arXiv:2404.16821; hf]

Per the brief, the InternViT vision frontend is a STUB: ``input_specs``
supplies 256 precomputed patch embeddings (B, 256, d_model) prepended to
the token stream; seq_len counts total positions.
"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92553,
    pattern=(BlockSpec(mixer="attn", ffn="dense"),),
    n_periods=48,
    act="silu",
    frontend="tokens+patches",
    n_patches=256,
)
