"""mamba2-2.7b [ssm] — 64L d_model=2560, attention-free SSD blocks,
ssm_state=128, vocab=50280.  [arXiv:2405.21060; unverified]

d_inner = 2*2560 = 5120, head_dim=64 → 80 SSD heads (TP-sharded 80/16=5).
Runs long_500k: decode state is O(1) in sequence length.
"""

from repro_torch.models.config import BlockSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    d_model=2560,
    n_heads=80,
    n_kv_heads=80,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    pattern=(BlockSpec(mixer="ssm", ffn="none"),),
    n_periods=64,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
)
