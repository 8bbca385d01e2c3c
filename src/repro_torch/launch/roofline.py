"""Roofline terms of a step on the H100, and the hand kernels' work.

The port of ``repro/launch/roofline.py``.  Three terms, each per card
(a rank of the step's world; card counts cancel):

    compute    = aten matmul FLOPs / PEAK_FLOPS
                 + each hand-kernel call's FLOPs / the peak of its type
    memory     = analytic HBM bytes / HBM_BW
    collective = each collective's result bytes / the rate of its group's
                 links (NVLINK_BW inside one node of NODE cards, NET_BW
                 across nodes)

Sources:
  * FLOPs, collective bytes and the kernels' calls come from one eager
    run of the step under ``cost_analysis.CostCounter`` (on fake tensors
    in a dry run), in place of the reference's HLO parse.
  * HBM bytes come from the reference's analytic traffic model
    (:func:`analytic_hbm_bytes`, line for line, with its pod assumption),
    so the two packages' memory terms agree exactly.
  * Peak memory is the counter's high-water mark of live storage plus the
    rank's arguments.

Constants (none measured): NVIDIA H100 SXM5 data sheet, dense rates
without sparsity at the 700 W power limit — 989 TFLOP/s bf16/f16 on the
tensor cores, 495 TFLOP/s TF32, 80 GB of HBM3 at 3.35 TB/s, NVLink 4 at
900 GB/s a card both ways (450 GB/s each way).  Between nodes: a DGX H100
node holds 8 cards, each with one 400 Gb/s NDR InfiniBand port, 50 GB/s
a card each way (NVIDIA DGX H100 user guide).

:func:`kernel_work` gives each hand kernel's work for one call from its
arguments' shapes: the operations it needs, the bytes it must move (each
input read once, each output written once) and the peak it is held to.
``chip_smoke.py`` computes its bounds from it; the counter adds it up.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import TYPE_CHECKING, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.models.config import ModelConfig, ShapeConfig

if TYPE_CHECKING:
    from repro_torch.launch.cost_analysis import ModuleCosts

__all__ = ["Roofline", "derive", "analytic_hbm_bytes", "kernel_work", "KernelWork",
           "attention_pairs", "link_of", "PEAK_FLOPS", "TF32_FLOPS", "HBM_BW",
           "HBM_PER_CARD", "NVLINK_BW", "NET_BW", "NODE"]

PEAK_FLOPS = 989e12  # bf16/f16 FLOP/s a card, dense, tensor cores
TF32_FLOPS = 495e12  # TF32 FLOP/s a card, dense: the f32 inputs' type
HBM_BW = 3.35e12  # bytes/s a card
HBM_PER_CARD = 80e9  # bytes
NVLINK_BW = 450e9  # bytes/s a card each way (the data sheet's 900 GB/s is both)
NET_BW = 50e9  # bytes/s a card each way between nodes (400 Gb/s NDR a card)
NODE = 8  # cards of one node, joined by NVLink


def analytic_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig, n_dev: int) -> float:
    """Per-device HBM traffic model for one step (documented lower bound).

    train:   master params fp32 read + bf16 cast write, per-microbatch
             param re-reads (remat), fp32 grad accumulate read+write,
             AdamW moments read+write (3R+3W fp32)
             + layer-boundary activations (write fwd, read bwd, ~2x remat).
    prefill: bf16 params once + activations + cache write.
    decode:  bf16 params once per token + full cache read + cache write.
    """
    N = cfg.approx_params()
    N_act = cfg.active_params()
    L = cfg.n_layers
    D = cfg.d_model
    B, T = shape.global_batch, shape.seq_len
    # data-parallel width of the batch (256-chip pod: 16; batch may not shard)
    dp = min(16, B) if B >= 1 else 1
    B_dev = max(B // dp, 1)
    if shape.kind == "train":
        n_mb = shape.microbatches
        param_traffic = N / n_dev * (4 + 2 + n_mb * 2 + n_mb * 8 + 24)
        act_traffic = 6.0 * L * B_dev * T * D * 2
        return param_traffic + act_traffic
    if shape.kind == "prefill":
        param_traffic = 2.0 * N / n_dev
        act_traffic = 4.0 * L * B_dev * T * D * 2
        return param_traffic + act_traffic
    # decode: one token
    param_traffic = 2.0 * N_act / n_dev
    cache = _cache_bytes(cfg, shape) / n_dev
    return param_traffic + 2.0 * cache


def _cache_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Total decode-cache bytes across the fleet (read each step)."""
    B, S = shape.global_batch, shape.seq_len
    total = 0.0
    for blk in cfg.all_blocks():
        if blk.mixer in ("attn", "local"):
            s_eff = min(S, blk.window) if blk.window else S
            total += 2 * B * s_eff * cfg.n_kv_heads * cfg.head_dim * 2
        elif blk.mixer == "mla":
            m = cfg.mla
            total += B * S * (m.kv_lora_rank + m.qk_rope_head_dim) * 2
        elif blk.mixer == "ssm":
            s = cfg.ssm
            total += (
                B * s.n_heads(cfg.d_model) * s.head_dim * s.d_state * 4
            )
        elif blk.mixer == "rglru":
            total += B * (cfg.rglru.lru_width or cfg.d_model) * 4
    return total


def link_of(ranks) -> str:
    """"nvlink" when every rank of a group lies in one node of
    :data:`NODE` consecutive ranks, else "net"."""
    return "nvlink" if len({r // NODE for r in ranks}) <= 1 else "net"


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops: float  # per-device: aten matmul FLOPs + the hand kernels' FLOPs
    hbm_bytes: float  # per-device, analytic model
    coll_bytes: int  # per-device collective result bytes
    coll_breakdown: Dict[str, int] = field(default_factory=dict)  # by kind
    coll_link_bytes: Dict[str, int] = field(default_factory=dict)  # nvlink / net
    kernel_flops: float = 0.0  # the hand kernels' part of ``flops``
    kernel_compute_s: float = 0.0  # each kernel call's FLOPs at its type's peak
    kernel_calls: Dict[str, int] = field(default_factory=dict)
    peak_memory_bytes: Optional[float] = None
    model_flops: Optional[float] = None  # 6·N_active·D / n_dev

    @property
    def t_compute(self) -> float:
        return (self.flops - self.kernel_flops) / PEAK_FLOPS + self.kernel_compute_s

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return (self.coll_link_bytes.get("nvlink", 0) / NVLINK_BW
                + self.coll_link_bytes.get("net", 0) / NET_BW)

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_frac(self) -> Optional[float]:
        """MODEL_FLOPS / counted FLOPs — remat/redundancy/attention waste."""
        if not self.model_flops or not self.flops:
            return None
        return self.model_flops / self.flops

    @property
    def roofline_frac(self) -> float:
        """Achievable MFU at this layout: useful model FLOPs over the time
        the dominant term dictates (perfect overlap assumption)."""
        tmax = max(self.t_compute, self.t_memory, self.t_collective)
        if not tmax or not self.model_flops:
            return 0.0
        return (self.model_flops / PEAK_FLOPS) / tmax

    @property
    def fits_hbm(self) -> Optional[bool]:
        if self.peak_memory_bytes is None:
            return None
        return self.peak_memory_bytes <= HBM_PER_CARD

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(
            t_compute=self.t_compute,
            t_memory=self.t_memory,
            t_collective=self.t_collective,
            bottleneck=self.bottleneck,
            useful_flops_frac=self.useful_flops_frac,
            roofline_frac=self.roofline_frac,
            fits_hbm=self.fits_hbm,
        )
        return d


def derive(
    arch: str,
    shape_name: str,
    mesh_name: str,
    costs: "ModuleCosts",
    n_devices: int,
    cfg: ModelConfig,
    shape: ShapeConfig,
    model_flops_global: Optional[float] = None,
    peak_memory_bytes: Optional[float] = None,
) -> Roofline:
    """The step's roofline from one rank's counts (``CostCounter.costs``)
    and its peak memory (arguments plus the counter's high-water mark)."""
    kernel_flops = sum(costs.kernel_flops.values())
    return Roofline(
        arch=arch,
        shape=shape_name,
        mesh=mesh_name,
        flops=costs.dot_flops + kernel_flops,
        hbm_bytes=analytic_hbm_bytes(cfg, shape, n_devices),
        coll_bytes=costs.total_collective_bytes,
        coll_breakdown=dict(costs.collective_bytes),
        coll_link_bytes=dict(costs.link_bytes),
        kernel_flops=kernel_flops,
        kernel_compute_s=sum(costs.kernel_compute_s.values()),
        kernel_calls=dict(costs.kernel_calls),
        peak_memory_bytes=peak_memory_bytes,
        model_flops=(model_flops_global / n_devices)
        if model_flops_global
        else None,
    )


# -- the hand kernels' work ---------------------------------------------------

class KernelWork(NamedTuple):
    """One call's work: the operations it needs, the bytes it must move
    (each input read once, each output written once), and the FLOP/s peak
    its operations are held to (None: it does no arithmetic worth a peak)."""

    flops: float
    bytes: float
    peak: Optional[float]

    @property
    def ops_ms(self) -> float:
        return self.flops / self.peak * 1e3 if self.peak else 0.0

    @property
    def bytes_ms(self) -> float:
        return self.bytes / HBM_BW * 1e3

    @property
    def bound_ms(self) -> float:
        """The least time the card could take: the larger of the two."""
        return max(self.ops_ms, self.bytes_ms)

    @property
    def bound_by(self) -> str:
        return "operations" if self.ops_ms >= self.bytes_ms else "bytes"


def _peak(dtype: torch.dtype) -> float:
    """The tensor cores' peak for inputs of ``dtype`` (f32 runs as TF32)."""
    return TF32_FLOPS if dtype == torch.float32 else PEAK_FLOPS


def _rows_seen(n: int, m: int) -> int:
    """``sum(min(i + 1, m) for i in range(n))``."""
    if n <= m:
        return n * (n + 1) // 2
    return m * (m + 1) // 2 + (n - m) * m


def attention_pairs(Tq: int, Tk: int, causal: bool = True,
                    window: Optional[int] = None) -> int:
    """The (query, key) pairs the attention mask keeps: query ``i`` sees
    key ``j`` when ``j <= i`` (causal) and ``i - j < window`` (with a
    window), ``flash_attention.live_mask``'s count in closed form."""
    seen = _rows_seen(Tq, Tk) if causal else Tq * Tk
    if window is None:
        return seen
    # keys j <= i - window fall out: min(max(0, i - window + 1), Tk) a row
    return seen - _rows_seen(max(0, Tq - window), Tk)


def flash_work(q, k, v, *, causal: bool = True, window: Optional[int] = None,
               **_) -> KernelWork:
    """Flash forward: q·k over dqk and p·v over dv for every kept pair;
    q, k, v read and o written once."""
    B, T, H, dh = q.shape
    Tk, dv = k.shape[1], v.shape[3]
    flops = 2 * B * H * (dh + dv) * attention_pairs(T, Tk, causal, window)
    nbytes = q.element_size() * (q.numel() + k.numel() + v.numel() + B * T * H * dv)
    return KernelWork(flops, nbytes, _peak(q.dtype))


def flash_bwd_work(q, k, v, o, do, lse, *, causal: bool = True,
                   window: Optional[int] = None, **_) -> KernelWork:
    """Flash backward: 5 products over each kept pair (Q·Kᵀ, dS·K and
    dSᵀ·Q of 2·dqk operations, dO·Vᵀ and Pᵀ·dO of 2·dv); q, o, do read and
    dq written, k, v read and dk, dv written, lse read.  The kernel runs 7
    (:func:`flash_bwd_as_run_flops`)."""
    B, T, H, dh = q.shape
    dv = v.shape[3]
    pairs = attention_pairs(T, k.shape[1], causal, window)
    flops = 2 * (3 * dh + 2 * dv) * pairs * B * H
    nbytes = (q.element_size() * 2 * (q.numel() + do.numel() + k.numel() + v.numel())
              + 4 * lse.numel())
    return KernelWork(flops, nbytes, _peak(q.dtype))


def flash_bwd_as_run_flops(q, k, v, *, causal: bool = True,
                           window: Optional[int] = None) -> int:
    """The 7 products the backward kernel runs a pair: its dq pass
    recomputes Q·Kᵀ and dO·Vᵀ."""
    B, T, H, dh = q.shape
    pairs = attention_pairs(T, k.shape[1], causal, window)
    return 2 * (4 * dh + 3 * v.shape[3]) * pairs * B * H


def decode_work(q, k_cache, v_cache, lengths=None, *, rows: Optional[int] = None,
                **_) -> KernelWork:
    """Decode: q read and o written, the k and v cache rows read once.
    ``rows`` is the rows the call's lengths cover (their sum); None counts
    every row of the cache, which is what a trace that cannot read the
    lengths knows (the reference's traffic model reads the whole cache
    too).  The bytes bound it."""
    B, H, dh = q.shape
    if rows is None:
        rows = B * k_cache.shape[1]
    Kv = k_cache.shape[2]
    nbytes = q.element_size() * (2 * q.numel() + 2 * rows * Kv * dh) + 4 * B
    return KernelWork(0, nbytes, None)


def ssd_work(x, dt, dA_cs, Bm, Cm, **_) -> KernelWork:
    """SSD chunk forward, B and C by head (a head stride of 0 for one
    group): each input read once (a stride-0 B/C once a chunk), y and the
    states written once; the least operations are C·Bᵀ once a chunk when
    every head reads one group, the causal products of each head."""
    BC, Q, H, P = x.shape
    N = Bm.shape[-1]
    bc_heads = [1 if t.stride(2) == 0 else H for t in (Bm, Cm)]
    nbytes = 4 * (2 * x.numel() + 2 * dt.numel()
                  + sum(BC * Q * h * N for h in bc_heads) + BC * H * P * N)
    pairs = Q * (Q + 1) // 2
    cb_sets = 1 if bc_heads == [1, 1] else H  # C.B^T computed per set
    flops = BC * (cb_sets * 2 * pairs * N + H * (2 * pairs * P + 2 * Q * P * N))
    return KernelWork(flops, nbytes, TF32_FLOPS)


def ssd_bwd_work(x, dt, dA_cs, Bm, Cm, dy, dS, **_) -> KernelWork:
    """SSD chunk backward, B and C by group: every input read once and
    every gradient written once; per head dW, Wᵀ·Y, B·dSᵀ and x·dS, per
    group C·Bᵀ, dC and dB's dGᵀ·C, at the TF32 peak."""
    BC, Q, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    pairs = Q * (Q + 1) // 2
    flops = BC * (H * (2 * 2 * pairs * P + 2 * 2 * Q * P * N) + G * 3 * 2 * pairs * N)
    # x, dy, dx; dS; dt, dA_cs, ddt, ddA_cs; B, C, dB, dC
    nbytes = 4 * (3 * x.numel() + dS.numel() + 4 * dt.numel() + 4 * Bm.numel())
    return KernelWork(flops, nbytes, TF32_FLOPS)


def histogram_work(keys, n_buckets: int, **_) -> KernelWork:
    """Bucket histogram: the keys read and the counts written once."""
    return KernelWork(0, 4 * keys.numel() + 4 * n_buckets, None)


#: each hand kernel's work function, by the name its wrapper reports
KERNEL_WORK: Dict[str, Callable[..., KernelWork]] = {
    "flash_attention": flash_work,
    "flash_attention_bwd": flash_bwd_work,
    "decode_attention": decode_work,
    "ssd_chunk": ssd_work,
    "ssd_chunk_bwd": ssd_bwd_work,
    "bucket_histogram": histogram_work,
}


def kernel_work(name: str, *args, **kw) -> KernelWork:
    """The work of one call of hand kernel ``name`` with these arguments
    (tensors, real or fake, and the wrapper's options)."""
    return KERNEL_WORK[name](*args, **kw)
