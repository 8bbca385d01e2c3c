"""hubert-xlarge [audio] — 48L d_model=1280 16H d_ff=5120 vocab=504.
Encoder-only (bidirectional); same trunk as wav2vec2.
[arXiv:2106.07447; unverified]

The CNN waveform frontend is a STUB per the brief: ``input_specs`` feeds
precomputed 512-d frame features, projected to d_model.  No decode step —
decode_32k / long_500k cells are skipped (DESIGN.md §5).
"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    pattern=(BlockSpec(mixer="attn", ffn="dense"),),
    n_periods=48,
    act="gelu_plain",
    norm="ln",
    causal=False,
    frontend="frames",
    frame_dim=512,
)
