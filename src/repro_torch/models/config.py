"""Model configuration schema shared by all 10 assigned architectures.

A copy of the reference package's framework-free schema
(``repro/models/config.py``), kept here so the port never imports it.

A model is: frontend (tokens / frames / tokens+patches) → ``prelude`` blocks
(unstacked) → ``n_periods × pattern`` blocks (stacked + scanned) →
``postlude`` blocks (unstacked) → final norm → unembed.

Heterogeneous stacks (gemma2's local/global alternation, recurrentgemma's
recurrent-recurrent-local pattern, deepseek's first-dense-then-MoE) are
expressed by the pattern machinery so scan-over-layers keeps the HLO small
for the 512-device dry-run compiles.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

__all__ = [
    "BlockSpec",
    "MoEConfig",
    "MLAConfig",
    "SSMConfig",
    "RGLRUConfig",
    "ModelConfig",
    "ShapeConfig",
]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    #: router softmax over all experts (deepseek) vs over top-k (dbrx-style)
    normalize_top_k: bool = True
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: Optional[int] = None  # v2-lite projects q directly


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0  # 0 -> d_model
    d_conv: int = 4
    c: float = 8.0  # recurrence sharpening exponent


@dataclass(frozen=True)
class BlockSpec:
    """One transformer block: a sequence mixer + an FFN."""

    mixer: str = "attn"  # attn | local | mla | ssm | rglru
    ffn: str = "dense"  # dense | moe | none (ssm blocks have no ffn)
    window: Optional[int] = None  # for mixer == "local"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # block structure
    prelude: Tuple[BlockSpec, ...] = ()
    pattern: Tuple[BlockSpec, ...] = (BlockSpec(),)
    n_periods: int = 1
    postlude: Tuple[BlockSpec, ...] = ()
    # flavor knobs
    act: str = "silu"
    norm: str = "rms"  # rms | ln
    rms_plus_one: bool = False
    embed_scale: bool = False  # gemma: embeddings * sqrt(d_model)
    qkv_bias: bool = False
    rope_theta: float = 1e4
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    post_block_norm: bool = False  # gemma2 pre+post norm sandwich
    causal: bool = True  # False = encoder (hubert)
    query_scale: Optional[float] = None  # override 1/sqrt(head_dim)
    #: pad attention heads up to the TP degree with dead (masked) heads so
    #: q/k/v shard on heads instead of head_dim — kills the per-chunk score
    #: all-reduces for H % 16 != 0 archs (see EXPERIMENTS.md §Perf)
    pad_heads: bool = False
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # frontend
    frontend: str = "tokens"  # tokens | frames | tokens+patches
    n_patches: int = 0  # for tokens+patches
    frame_dim: int = 0  # for frames (0 -> d_model)
    # numerics
    dtype: str = "bfloat16"

    @property
    def n_layers(self) -> int:
        return (
            len(self.prelude)
            + self.n_periods * len(self.pattern)
            + len(self.postlude)
        )

    def all_blocks(self) -> Tuple[BlockSpec, ...]:
        return self.prelude + self.pattern * self.n_periods + self.postlude

    def approx_params(self) -> int:
        """Rough parameter count (for roofline MODEL_FLOPS = 6·N·D)."""
        n = self.vocab * self.d_model * 2  # embed + unembed
        for blk in self.all_blocks():
            n += self._block_params(blk)
        return n

    def active_params(self) -> int:
        """Active (per-token) params — MoE counts only routed top-k."""
        n = self.vocab * self.d_model * 2
        for blk in self.all_blocks():
            n += self._block_params(blk, active_only=True)
        return n

    def _block_params(self, blk: BlockSpec, active_only: bool = False) -> int:
        d = self.d_model
        n = 0
        if blk.mixer in ("attn", "local"):
            n += d * self.n_heads * self.head_dim  # q
            n += 2 * d * self.n_kv_heads * self.head_dim  # k, v
            n += self.n_heads * self.head_dim * d  # o
        elif blk.mixer == "mla":
            m = self.mla
            n += d * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            n += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            n += self.n_heads * m.v_head_dim * d
        elif blk.mixer == "ssm":
            s = self.ssm
            di = s.d_inner(d)
            n += d * (2 * di + 2 * s.n_groups * s.d_state + s.n_heads(d))
            n += di * d
        elif blk.mixer == "rglru":
            w = self.rglru.lru_width or d
            n += 2 * d * w + 2 * w * w + w * d
        if blk.ffn == "dense":
            mult = 3 if self.act in ("silu", "gelu") else 2
            n += mult * d * self.d_ff
        elif blk.ffn == "moe":
            mcfg = self.moe
            e = mcfg.top_k if active_only else mcfg.n_experts
            n += 3 * e * d * mcfg.d_expert
            n += 3 * mcfg.n_shared * d * mcfg.d_expert
            n += d * mcfg.n_experts  # router
        return n


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell + the memory knobs tuned per cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int
    #: gradient-accumulation microbatches (train only)
    microbatches: int = 1
    #: chunk sizes for the streaming attention / CE loss
    q_chunk: int = 512
    kv_chunk: int = 1024
    loss_chunk: int = 512
    #: remat policy for the scanned blocks: "full" | "dots" | "none"
    remat: str = "full"


def reduced_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(
        d_model=64,
        n_heads=4,
        n_kv_heads=min(4, max(1, cfg.n_kv_heads)),
        head_dim=16,
        d_ff=128,
        vocab=256,
        n_periods=min(cfg.n_periods, 2),
        prelude=cfg.prelude[:1],
        postlude=cfg.postlude[:1],
        n_patches=min(cfg.n_patches, 4),
        frame_dim=64 if cfg.frame_dim else 0,
    )
    if cfg.moe is not None:
        kw["moe"] = replace(
            cfg.moe, n_experts=8, top_k=2, d_expert=32,
            n_shared=min(cfg.moe.n_shared, 1),
        )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16,
        )
    if cfg.ssm is not None:
        kw["ssm"] = replace(cfg.ssm, d_state=16, head_dim=16, chunk=16)
    if cfg.rglru is not None:
        kw["rglru"] = replace(cfg.rglru, lru_width=64)
    return replace(cfg, **kw)
