"""Model assembly: frontend → prelude → period body → postlude → final
norm → unembed, for blocks whose mixer is attention (``attn``/``local``),
multi-head latent attention (``mla``), Mamba-2 SSD (``ssm``) or RG-LRU
(``rglru``) and whose FFN is dense, MoE or absent: every configuration of
the reference package.

The port of ``repro/models/transformer.py``.  The parameter tree and the
cache tree keep the reference's layout and names: the repeating block
pattern is stacked along a leading ``n_periods`` axis (``params["body"]``
and ``cache["body"]``), so a reference tree converts leaf by leaf and the
KV pager pages the stacked body cache as one leaf.  The reference scans
over that axis with ``lax.scan``; here a Python loop indexes it.  Decode
writes each layer's new K/V or latent row, or its new conv window and
recurrent state, into the stacked cache in place.  ``forward`` returns
the MoE balance loss summed over the layers, as the reference does.

For training, ``forward`` takes the reference's remat policies per period
(``torch.utils.checkpoint``, non-reentrant) and a compute ``dtype``: f32
weights are cast at their point of use, inside the checkpointed period,
so their gradients land in the f32 masters and no bf16 copy of the tree
outlives its period.  A body leaf may come as :class:`Periods` (one
tensor per period) rather than stacked: indexing a stacked leaf that
requires grad would make autograd build a zero tensor of the whole stack
for every period's gradient.

On a mesh (the sharded train step) a leaf may come as :class:`Shard`, this
rank's FSDP block of a weight: :func:`cast_weights` gathers it over the
data axis where it casts, so a checkpointed period gathers its weights
again in its recompute (ZeRO-3), as the reference does per layer per
microbatch.  Every mixer, the MLP and the loss then see TP shards and run
tensor-parallel (``ctx``), and the MoE FFN routes over the step's layout
(``ShardCtx.row_axes``): the whole microbatch on the dense path, expert-
parallel over TP where TP divides the experts.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models import attention, mla, moe, rglru, ssm
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.ctx import ShardCtx
from repro_torch.models.layers import layer_norm, mlp_apply, mlp_defs, rms_norm, softcap
from repro_torch.models.param import FSDP, TP, ParamDef, default_device, stack_defs
from repro_torch.models.quant_cache import init_quant_cache
from repro_torch.parallel.collectives import all_gather, gather_shard
from repro_torch.tree import tree_map

__all__ = ["model_defs", "forward", "logits_fn", "decode_step", "init_cache",
           "Periods", "Shard", "REMAT_POLICIES", "cast_weights", "shard_moe_params"]

#: remat policies per layer period, the reference's ``shape.remat``
REMAT_POLICIES = ("none", "full", "dots", "save_block_out")


# -- defs ---------------------------------------------------------------

def _norm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    if cfg.norm == "ln":
        return {
            "scale": ParamDef((cfg.d_model,), (None,), init_value=1.0),
            "bias": ParamDef((cfg.d_model,), (None,), init_scale=0.0),
        }
    init = 0.0 if cfg.rms_plus_one else 1.0
    return {"scale": ParamDef((cfg.d_model,), (None,), init_value=init)}


def _norm_apply(p, x, cfg: ModelConfig):
    if cfg.norm == "ln":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"], plus_one=cfg.rms_plus_one)


def _mixer_defs(blk: BlockSpec, cfg: ModelConfig) -> Dict[str, ParamDef]:
    if blk.mixer in ("attn", "local"):
        return attention.attn_defs(cfg)
    if blk.mixer == "mla":
        return mla.mla_defs(cfg)
    if blk.mixer == "ssm":
        return ssm.ssm_defs(cfg)
    if blk.mixer == "rglru":
        return rglru.rglru_defs(cfg)
    raise ValueError(blk.mixer)


def _ffn_defs(blk: BlockSpec, cfg: ModelConfig) -> Optional[Dict[str, ParamDef]]:
    if blk.ffn == "dense":
        # encoder-style plain MLP when act is gelu_plain
        return mlp_defs(cfg.d_model, cfg.d_ff, gated=cfg.act != "gelu_plain")
    if blk.ffn == "moe":
        return moe.moe_defs(cfg)
    if blk.ffn == "none":
        return None
    raise ValueError(blk.ffn)


def _block_defs(blk: BlockSpec, cfg: ModelConfig) -> Dict[str, Any]:
    defs: Dict[str, Any] = {
        "norm1": _norm_defs(cfg),
        "mixer": _mixer_defs(blk, cfg),
    }
    if blk.ffn != "none":
        defs["norm2"] = _norm_defs(cfg)
        defs["ffn"] = _ffn_defs(blk, cfg)
    if cfg.post_block_norm:
        defs["post1"] = _norm_defs(cfg)
        if blk.ffn != "none":
            defs["post2"] = _norm_defs(cfg)
    return defs


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    D, V = cfg.d_model, cfg.vocab
    defs: Dict[str, Any] = {}
    if cfg.frontend in ("tokens", "tokens+patches"):
        defs["embed"] = ParamDef((V, D), (None, FSDP), init_scale=0.02)
    if cfg.frontend == "frames":
        fd = cfg.frame_dim or D
        defs["frame_proj"] = {
            "w": ParamDef((fd, D), (None, FSDP)),
            "b": ParamDef((D,), (None,), init_scale=0.0),
        }
    defs["prelude"] = [_block_defs(b, cfg) for b in cfg.prelude]
    defs["body"] = [
        stack_defs(_block_defs(b, cfg), cfg.n_periods) for b in cfg.pattern
    ]
    defs["postlude"] = [_block_defs(b, cfg) for b in cfg.postlude]
    defs["final_norm"] = _norm_defs(cfg)
    defs["unembed"] = ParamDef((D, V), (None, TP))
    return defs


# -- tree helpers ---------------------------------------------------------

class Periods(list):
    """A body leaf held as one tensor per period instead of one stacked
    tensor (the training step's per-period autograd leaves)."""


class Shard:
    """A weight held as this rank's block along ``dim`` over the data
    axis's process ``group`` (FSDP), gathered whole by
    :func:`cast_weights`; ``gathered`` is that gather made once a step
    beforehand (ZeRO-1), or None."""

    __slots__ = ("t", "dim", "group", "gathered")

    def __init__(self, t: torch.Tensor, dim: int, group,
                 gathered: Optional[torch.Tensor] = None):
        self.t, self.dim, self.group, self.gathered = t, dim, group, gathered

    def gather(self, dtype: Optional[torch.dtype]) -> torch.Tensor:
        """The whole weight in ``dtype`` where the master is f32 (as
        :func:`cast_weights` casts), else (or with None) in the master's
        type."""
        if self.t.dtype != torch.float32 or dtype is None:
            dtype = self.t.dtype
        return gather_shard(self.t, dtype, self.dim, self.group, self.gathered)


def _period(tree: Any, i: int) -> Any:
    """Period ``i`` of a stacked parameter or cache tree (views, no copy)."""
    if isinstance(tree, (torch.Tensor, Periods)):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _period(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_period(v, i) for v in tree))
    return type(tree)(_period(v, i) for v in tree)


def _stack(caches: List[Any]) -> Any:
    """Stack per-period caches along a new leading period axis."""
    first = caches[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(caches)
    return type(first)(*(_stack(list(f)) for f in zip(*caches)))


def shard_moe_params(params: Dict[str, Any], cfg: ModelConfig,
                     ctx: ShardCtx) -> Dict[str, Any]:
    """``params`` with each MoE layer's parameters cut to this rank's
    slices for ``ctx``'s mesh (``moe.shard_params``; the body's stacked
    layers keep their period axis).  Every other leaf is shared with
    ``params``."""
    def cut(p, blk):
        if blk.ffn != "moe":
            return p
        return {**p, "ffn": moe.shard_params(p["ffn"], ctx.mesh, ctx.dp_axes,
                                             ctx.tp_axis, ctx.zero1)}

    return {**params,
            "prelude": [cut(p, b) for p, b in zip(params["prelude"], cfg.prelude)],
            "body": [cut(p, b) for p, b in zip(params["body"], cfg.pattern)],
            "postlude": [cut(p, b) for p, b in zip(params["postlude"], cfg.postlude)]}


# -- apply ---------------------------------------------------------------

def cast_weights(tree: Any, dtype: Optional[torch.dtype], *,
                 shards: bool = False) -> Any:
    """``tree`` with every f32 leaf of rank >= 1 cast to ``dtype`` (None:
    as it is), as the reference's train step casts its f32 masters, and
    every :class:`Shard` gathered.  The sharded train step always gives a
    ``dtype``; the serving steps on a mesh give None and ``shards``, so
    that their Shards are gathered in the weights' own type."""
    if dtype is None and not shards:
        return tree

    def cast(t):
        if isinstance(t, Shard):
            return t.gather(dtype)
        if dtype is None:
            return t
        return t.to(dtype) if t.dtype == torch.float32 and t.dim() > 0 else t

    return tree_map(cast, tree)


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for "dots": keep the outputs of the
    matmuls without batch dims, recompute the rest (the reference's
    ``dots_with_no_batch_dims_saveable``)."""
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """``fn`` under the remat policy: "none" as it is; "full" keeps only
    its inputs; "dots" keeps its matmul outputs too.  ("save_block_out"
    checkpoints each block's mixer and FFN halves: see
    ``_saving_halves``.)"""
    if policy == "none":
        return fn
    if policy == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if policy == "dots":
        return lambda *a: checkpoint(
            fn, *a, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(_save_matmuls))
    raise ValueError(f"remat policy {policy!r} not in {REMAT_POLICIES}")


def _embed_scale(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if not cfg.embed_scale:
        return x
    # the constant rounded to x's type first, as the reference does
    c = torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()
    return x * c


def _frontend(params, cfg: ModelConfig, inputs: Dict[str, torch.Tensor]):
    if cfg.frontend == "tokens":
        x = F.embedding(inputs["tokens"].long(), params["embed"])
    elif cfg.frontend == "frames":
        fp = params["frame_proj"]
        x = inputs["frames"] @ fp["w"] + fp["b"]
    elif cfg.frontend == "tokens+patches":
        tok = F.embedding(inputs["tokens"].long(), params["embed"])
        x = torch.cat([inputs["patches"].to(tok.dtype), tok], dim=1)
    else:
        raise ValueError(cfg.frontend)
    return _embed_scale(x, cfg)


def _mixer_apply(p, x, blk: BlockSpec, cfg: ModelConfig,
                 collect_cache: bool = False, cache_len=None,
                 ctx: Optional[ShardCtx] = None):
    if blk.mixer in ("attn", "local"):
        out = attention.attn_apply(
            p, x, cfg,
            window=blk.window if blk.mixer == "local" else None,
            collect_cache=collect_cache, cache_len=cache_len, ctx=ctx,
        )
    elif blk.mixer == "mla":
        out = mla.mla_apply(p, x, cfg, collect_cache=collect_cache,
                            cache_len=cache_len, ctx=ctx)
    elif blk.mixer == "ssm":
        out = ssm.ssm_apply(p, x, cfg, collect_cache=collect_cache, ctx=ctx)
    elif blk.mixer == "rglru":
        out = rglru.rglru_apply(p, x, cfg, collect_cache=collect_cache, ctx=ctx)
    else:
        raise ValueError(blk.mixer)
    return out if collect_cache else (out, None)


def _ffn_apply(p, x, blk: BlockSpec, cfg: ModelConfig, ctx: Optional[ShardCtx] = None):
    """The FFN's output and its aux loss (None but for MoE)."""
    if blk.ffn == "dense":
        act = "gelu" if cfg.act == "gelu_plain" else cfg.act
        group = None if ctx is None else ctx.tp_group(p["wo"].shape[0], cfg.d_ff)
        return mlp_apply(p, x, act, group), None
    if blk.ffn == "moe":
        if ctx is None:
            return moe.moe_apply(p, x, cfg)
        shared = None
        if cfg.moe.n_shared:  # the shared expert's weights may arrive cut over TP
            shared = ctx.tp_group(p["shared"]["wo"].shape[0],
                                  cfg.moe.n_shared * cfg.moe.d_expert)
        return moe.moe_apply(p, x, cfg, ctx.mesh, ctx.dp_axes, ctx.tp_axis,
                             zero1=ctx.zero1, row_axes=ctx.row_axes,
                             shared_group=shared)
    raise ValueError(blk.ffn)


def _direct(fn, q, x):
    return fn(q, x)


def _finish_block(p, x, h, blk: BlockSpec, cfg: ModelConfig, half=_direct,
                  ctx: Optional[ShardCtx] = None):
    """The residual add of the mixer output ``h``, then the FFN sub-block
    (prefill and decode alike), run through ``half`` (see
    ``_block_apply``).  Returns (x, the FFN's aux loss or None)."""
    if cfg.post_block_norm:
        h = _norm_apply(p["post1"], h, cfg)
    x = x + h
    aux = None
    if blk.ffn != "none":
        def ffn(q, x_):
            return _ffn_apply(q["ffn"], _norm_apply(q["norm2"], x_, cfg), blk, cfg,
                              ctx)

        h, aux = half(ffn, {"norm2": p["norm2"], "ffn": p["ffn"]}, x)
        if cfg.post_block_norm:
            h = _norm_apply(p["post2"], h, cfg)
        x = x + h
    return x, aux


def _block_apply(p, x, blk: BlockSpec, cfg: ModelConfig,
                 collect_cache: bool = False, cache_len=None, half=_direct,
                 ctx: Optional[ShardCtx] = None):
    """One block.  Its mixer half and its FFN half each run as
    ``half(fn, q, x)``, ``fn(q, x)`` over the half's own slice ``q`` of
    ``p``: directly, or checkpointed under "save_block_out"."""
    def mixer(q, x_):
        return _mixer_apply(q["mixer"], _norm_apply(q["norm1"], x_, cfg), blk,
                            cfg, collect_cache, cache_len, ctx)

    h, cache = half(mixer, {"norm1": p["norm1"], "mixer": p["mixer"]}, x)
    x, aux = _finish_block(p, x, h, blk, cfg, half, ctx)
    return x, aux, cache


def _saving_halves(dtype):
    """``half`` for "save_block_out": each half checkpointed, so the
    backward pass keeps the mixer and FFN outputs and recomputes what lies
    inside them, with the half's weights cast inside the checkpoint."""
    def half(fn, q, x):
        return checkpoint(lambda q_, x_: fn(cast_weights(q_, dtype), x_), q, x,
                          use_reentrant=False)
    return half


def forward(
    params: Dict[str, Any],
    cfg: ModelConfig,
    inputs: Dict[str, torch.Tensor],
    collect_cache: bool = False,
    cache_len: Optional[int] = None,
    *,
    remat: str = "none",
    dtype: Optional[torch.dtype] = None,
    ctx: Optional[ShardCtx] = None,
):
    """Full-sequence forward.  Returns (hidden (B, T, D), aux loss) or,
    with ``collect_cache`` (prefill), (hidden, aux, cache tree).
    ``cache_len`` reserves decode headroom in the collected caches.  The
    aux loss is the MoE balance loss summed over the MoE layers (0 when
    there are none), in f32.

    ``remat`` (one of :data:`REMAT_POLICIES`) recomputes each body period
    in the backward pass, as the reference's ``shape.remat`` does; it acts
    only when autograd records (and never with ``collect_cache``).
    ``dtype`` casts f32 weights to the compute type where they are used
    (:func:`cast_weights`); None computes in the weights' own types.
    ``ctx`` (a :class:`ShardCtx` with a mesh) runs the MoE layers expert-
    parallel over it where TP divides the experts, with their parameters
    as :func:`shard_moe_params` cuts them (or, with ``ctx.row_axes``, as
    the sharded train step hands them), and every mixer and the dense MLP
    tensor-parallel where their weights arrive as TP shards
    (:class:`Shard` leaves are gathered over FSDP where they are cast);
    None computes on one device."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat policy {remat!r} not in {REMAT_POLICIES}")
    if collect_cache or not torch.is_grad_enabled():
        remat = "none"
    on_mesh = ctx is not None and ctx.mesh is not None
    x = _frontend(cast_weights(
        {k: params[k] for k in ("embed", "frame_proj") if k in params}, dtype,
        shards=on_mesh), cfg, inputs)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches: Dict[str, List[Any]] = {"prelude": [], "body": [], "postlude": []}

    def add(total, a):
        return total if a is None else total + a

    def block(p, blk):
        nonlocal x, aux
        x, a, c = _block_apply(cast_weights(p, dtype, shards=on_mesh), x, blk, cfg,
                               collect_cache, cache_len, ctx=ctx)
        aux = add(aux, a)
        return c

    for p, blk in zip(params["prelude"], cfg.prelude):
        caches["prelude"].append(block(p, blk))

    def period(x_, aux_, i):
        for j, blk in enumerate(cfg.pattern):
            p = _period(params["body"][j], i)
            if remat == "save_block_out":
                # the norms cast here; the halves cast their own weights
                p = {k: v if k in ("mixer", "ffn") else cast_weights(v, dtype)
                     for k, v in p.items()}
                x_, a, _ = _block_apply(p, x_, blk, cfg, half=_saving_halves(dtype),
                                        ctx=ctx)
            else:
                x_, a, _ = _block_apply(cast_weights(p, dtype), x_, blk, cfg, ctx=ctx)
            aux_ = add(aux_, a)
        return x_, aux_

    body: List[List[Any]] = [[] for _ in cfg.pattern]
    if collect_cache:
        for i in range(cfg.n_periods):
            for j, blk in enumerate(cfg.pattern):
                body[j].append(block(_period(params["body"][j], i), blk))
        if cfg.n_periods > 0:
            caches["body"] = [_stack(cs) for cs in body]
    else:
        period_fn = _remat(period, "none" if remat == "save_block_out" else remat)
        for i in range(cfg.n_periods):
            x, aux = period_fn(x, aux, i)

    for p, blk in zip(params["postlude"], cfg.postlude):
        caches["postlude"].append(block(p, blk))

    x = _norm_apply(cast_weights(params["final_norm"], dtype, shards=on_mesh), x, cfg)
    if collect_cache:
        return x, aux, caches
    return x, aux


def logits_fn(params, cfg: ModelConfig, x: torch.Tensor,
              ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """Final logits (fp32, softcapped). x: (..., D).  With ``ctx``, an
    ``unembed`` cut over TP on the vocab (the serving steps on a mesh)
    gives every rank's block, gathered."""
    unembed = params["unembed"]
    logits = softcap((x @ unembed).float(), cfg.final_softcap)
    group = None if ctx is None else ctx.tp_group(unembed.shape[-1], cfg.vocab)
    return logits if group is None else all_gather(logits, group, logits.dim() - 1)


# -- decode ---------------------------------------------------------------

def _mixer_cache(blk: BlockSpec, cfg: ModelConfig, batch: int, seq_len: int,
                 dtype, quant_attn: bool, device):
    if blk.mixer == "mla":
        return mla.init_mla_cache(cfg, batch, seq_len, dtype, device=device)
    if blk.mixer == "ssm":
        return ssm.init_ssm_cache(cfg, batch, dtype, device=device)
    if blk.mixer == "rglru":
        return rglru.init_rglru_cache(cfg, batch, dtype, device=device)
    if blk.mixer not in ("attn", "local"):
        raise ValueError(blk.mixer)
    window = blk.window if blk.mixer == "local" else None
    if quant_attn:
        return init_quant_cache(cfg, batch, seq_len, window, device=device)
    return attention.init_attn_cache(cfg, batch, seq_len, window, dtype,
                                     device=device)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, quant_attn: bool = False, device=None):
    """Decode cache tree on ``device`` (default: the card); ``quant_attn``
    uses int8 attention caches.  Body caches carry the leading
    ``n_periods`` axis."""
    device = default_device(device)
    mk = lambda b: _mixer_cache(b, cfg, batch, seq_len, dtype, quant_attn, device)
    return {
        "prelude": [mk(b) for b in cfg.prelude],
        "body": [_stack([mk(b) for _ in range(cfg.n_periods)])
                 if cfg.n_periods else mk(b) for b in cfg.pattern],
        "postlude": [mk(b) for b in cfg.postlude],
    }


def _block_decode(p, x, cache, t: int, blk: BlockSpec, cfg: ModelConfig,
                  ctx: Optional[ShardCtx] = None):
    xn = _norm_apply(p["norm1"], x, cfg)
    if blk.mixer in ("attn", "local"):
        h, new_cache = attention.attn_decode(
            p["mixer"], xn, cache, t, cfg, ctx=ctx,
            window=blk.window if blk.mixer == "local" else None)
    elif blk.mixer == "mla":
        h, new_cache = mla.mla_decode(p["mixer"], xn, cache, t, cfg, ctx)
    elif blk.mixer == "ssm":
        h, new_cache = ssm.ssm_decode(p["mixer"], xn, cache, cfg, ctx)
    elif blk.mixer == "rglru":
        h, new_cache = rglru.rglru_decode(p["mixer"], xn, cache, cfg, ctx)
    else:
        raise ValueError(blk.mixer)
    return _finish_block(p, x, h, blk, cfg, ctx=ctx)[0], new_cache


def decode_step(
    params: Dict[str, Any],
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, 1) current token ids
    cache: Dict[str, Any],
    t: int,  # position of `tokens`
    ctx: Optional[ShardCtx] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One-token decode.  Returns (logits (B, V) fp32, the cache tree),
    whose layers were updated in place.  ``ctx`` as for :func:`forward`;
    on a mesh (the serving steps) the weights may hold :class:`Shard`
    leaves, gathered layer by layer, and the cache is this rank's blocks
    (``ShardCtx.cache_len``); the logits are gathered over TP where
    ``unembed`` is cut over the vocab."""
    on_mesh = ctx is not None and ctx.mesh is not None

    def use(tree):
        return cast_weights(tree, None, shards=on_mesh)

    x = _frontend(use({k: params[k] for k in ("embed", "frame_proj") if k in params}),
                  cfg, {"tokens": tokens})

    new_prelude = []
    for p, c, blk in zip(params["prelude"], cache["prelude"], cfg.prelude):
        x, nc = _block_decode(use(p), x, c, t, blk, cfg, ctx)
        new_prelude.append(nc)

    for i in range(cfg.n_periods):
        for j, blk in enumerate(cfg.pattern):
            x, _ = _block_decode(use(_period(params["body"][j], i)), x,
                                 _period(cache["body"][j], i), t, blk, cfg, ctx)

    new_postlude = []
    for p, c, blk in zip(params["postlude"], cache["postlude"], cfg.postlude):
        x, nc = _block_decode(use(p), x, c, t, blk, cfg, ctx)
        new_postlude.append(nc)

    x = _norm_apply(use(params["final_norm"]), x, cfg)
    logits = logits_fn(use({"unembed": params["unembed"]}), cfg, x[:, 0], ctx)
    return logits, {
        "prelude": new_prelude,
        "body": list(cache["body"]),
        "postlude": new_postlude,
    }
