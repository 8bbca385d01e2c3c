"""Step factories: the train step (f32 masters, bf16 compute, microbatched
gradient accumulation, optional int8 gradient compression, AdamW), on one
card or sharded over a mesh, and the prefill and decode steps.

The port of ``repro/launch/steps.py``.  The reference's factories return
a ``StepBundle`` (the step, its shardings and argument stand-ins for the
dry-run, partitioned by GSPMD); here each returns the step itself, a
plain callable that runs eagerly.  The reference casts the whole f32 tree
to bf16 once per step; here the weights are cast inside each checkpointed
layer period (``models.transformer.forward``'s ``dtype``), so no bf16
copy of the tree stays resident: at qwen2.5-3b's full width the f32
masters, the two moments and the f32 gradients take 54 GB of the card's
80.  Each microbatch's ``backward()`` accumulates its gradients into one
f32 buffer, which is divided by the number of microbatches, optionally
compressed, and handed to AdamW, which updates the masters and moments in
place.

With ``mesh`` (a ``DeviceMesh`` over ``torch.distributed``, one process
per rank) the train step is the reference's FSDP×TP step, with its
collectives written out: every rank holds its own shard of every leaf
(``parallel.sharding.param_pspecs``: FSDP over "data", TP over "model"),
and so do the moments, the gradients and the error-feedback residual.
Inside each period a leaf's bf16 weight is gathered over "data"
(``models.transformer.Shard``; again in remat's recompute), and its f32
gradient reduce-scattered back in the backward pass; with ``zero1`` the
weights are gathered once a step, in the TP-only layout, and each
microbatch's gradient still reduce-scatters to the FSDP layout.
Attention, the dense MLP and the loss run tensor-parallel over "model".
Microbatch rows split over the data axes (replicated where they do not
divide), the loss of a rank's rows is its CE sum over the microbatch's
global count of valid tokens, and the gradients of leaves replicated
over the data axes are all-reduced over them, of FSDP leaves over "pod".
Both run one step body: without a mesh its layout (``_Layout``) takes
every row, keeps the leaves whole and reduces nothing, and an axis of
one rank is skipped the same way, so a (1, 1) mesh computes as one card.
Every mixer runs tensor-parallel over "model" (attention, MLA and SSM
over heads, RG-LRU over its width).  A leaf replicated over TP whose
per-rank gradient is partial, because each rank uses it only for its
own heads or tokens, has that gradient summed over TP
(:func:`_tp_partial_flags`): attention's replicated kv projections,
SSM's ``wB``, ``wC``, ``conv_w`` and ``conv_b``, MLA's ``wkv_a`` and
``kv_norm``, and the router of the a2a MoE path.  A replicated leaf used
whole on identical activations (a norm's scale, the gather path's
router) is not summed.  The MoE layers route over the step's rows
(``ShardCtx.row_axes``): the dense path routes the whole microbatch from
each rank's block of it, as the reference's GSPMD layout does, and the
expert-parallel paths route each (data block, TP slice) on its own, as
the reference's ``shard_map`` bodies do, their balance losses averaged
over the ranks.

``make_prefill_step`` and ``make_decode_step`` are the reference's
serving steps (the serve launcher's prefill and greedy decode), and
``make_step`` picks one by ``shape.kind``.  On a mesh they take and
return each rank's shards (:class:`_ServeLayout`): weights by
``param_pspecs`` (gathered over FSDP layer by layer), rows over the data
axes, caches by ``cache_pspecs``, whose KV and MLA caches are cut on the
sequence over TP; every layer writes out its collectives (the attention
layers combine their blocks' partial softmaxes, ``combine_partials``).  ``make_ctx`` builds the
layers' mesh context.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.models import ModelConfig, ShapeConfig, decode_step, forward, logits_fn
from repro_torch.models import attention, mla, moe, ssm
from repro_torch.models.ctx import ShardCtx
from repro_torch.models.layers import chunked_ce_loss
from repro_torch.models.param import default_device
from repro_torch.models.transformer import Periods, Shard, cast_weights
from repro_torch.optim.adamw import AdamWConfig, OptState, adamw_update
from repro_torch.optim.compression import EFState, compress_decompress
from repro_torch.parallel.collectives import LeafReducer, all_gather
from repro_torch.parallel.sharding import (
    _map_specs, batch_entry, mesh_axes, mesh_shape, param_pspecs, spec_axes,
    spec_leaves)
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step", "make_step",
           "autograd_leaves", "make_ctx"]

#: the type the step computes in; the masters stay f32
COMPUTE_DTYPE = torch.bfloat16


def autograd_leaves(params: Dict[str, Any], grads: Dict[str, Any]) -> Dict[str, Any]:
    """The tree the forward pass differentiates: each leaf a detached view
    of its master that requires grad, with ``.grad`` already set to its
    slot of ``grads``, so ``backward()`` adds into ``grads`` in place.  A
    stacked body leaf becomes :class:`Periods`, one view per period: were
    the stacked master indexed under autograd, every period's gradient
    would first be a zero tensor the size of the whole stack."""
    def leaf(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        v = p.detach().requires_grad_()
        v.grad = g
        return v

    def per_period(p: torch.Tensor, g: torch.Tensor) -> Periods:
        return Periods(leaf(p[i], g[i]) for i in range(p.shape[0]))

    return {k: tree_map(per_period if k == "body" else leaf, params[k], grads[k])
            for k in params}


def make_ctx(mesh) -> ShardCtx:
    """The layers' mesh context for ``mesh`` (a ``DeviceMesh`` or None): its
    data axes and TP axis, named as the reference names them."""
    if mesh is None:
        return ShardCtx()
    dp, _, tp = mesh_axes(mesh)
    return ShardCtx(mesh=mesh, dp_axes=dp or ("data",), tp_axis=tp or "model")


def _to_device(x: Any, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


def make_train_step(
    cfg: ModelConfig,
    shape: ShapeConfig,
    opt_cfg: AdamWConfig = AdamWConfig(),
    aux_coef: float = 0.01,
    compress_grads: bool = False,
    device: Any = None,
    mesh=None,
    zero1: bool = False,
) -> Callable:
    """A step ``(params, opt_state, batch[, ef]) -> (params, opt_state,
    metrics[, ef])`` over f32 ``params`` on ``device`` (default: the
    card).  ``batch`` maps ``tokens`` (and ``labels``, -100 ignored) to
    ``(shape.global_batch, T)`` arrays or tensors.  The step updates the
    parameters and moments in place and returns them.  ``metrics``: the
    mean CE loss over the microbatches, ``tokens`` counted, the gradient
    norm before clipping, the new ``step``, and with compression the mean
    quantization error; all 0-dim tensors on the device (reading one
    synchronizes).

    With ``mesh`` the step is sharded (module docstring): ``params``,
    ``opt_state``'s moments and ``ef`` hold this rank's shards by
    ``param_pspecs(cfg, mesh)`` (``parallel.sharding.shard_tree`` cuts
    them), ``batch`` is the whole batch on every rank, and ``metrics``
    are global, the same on every rank.  ``zero1`` gathers the weights
    once a step instead of in every period."""
    device = default_device(device)
    n_mb = shape.microbatches
    B = shape.global_batch
    if B % n_mb:
        raise ValueError(f"global batch {B} does not split into {n_mb} microbatches")
    if zero1 and mesh is None:
        raise ValueError("zero1 shards the optimizer state: it needs a mesh")
    lay = _Layout(cfg, B // n_mb, shape.seq_len, mesh, zero1)

    def train_step(params: Dict[str, Any], opt_state: OptState,
                   batch: Dict[str, Any], ef_state: Optional[EFState] = None):
        grads = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            params)
        leaves = lay.shards(params, autograd_leaves(params, grads))
        mbs = {k: _to_device(v, device).chunk(n_mb) for k, v in batch.items()}
        losses, counts = [], []
        for i in range(n_mb):
            labels = mbs["labels"][i]
            inputs = {k: v[i][lay.rows] for k, v in mbs.items() if k != "labels"}
            h, aux = forward(leaves, cfg, inputs, remat=shape.remat,
                             dtype=COMPUTE_DTYPE, ctx=lay.ctx)
            unembed = cast_weights(leaves["unembed"], COMPUTE_DTYPE)
            loss, n = chunked_ce_loss(
                h, unembed, labels[lay.rows], t_chunk=shape.loss_chunk,
                logit_softcap=cfg.final_softcap, tp_group=lay.tp_group(unembed),
                n_total=lay.n_total(labels))
            (loss + aux_coef * aux).backward()
            losses.append(loss.detach())
            counts.append(n)
            del h, aux, loss, unembed
        del leaves
        lay.reduce_grads(grads, n_mb)
        metrics: Dict[str, torch.Tensor] = {}
        new_ef = ef_state
        if compress_grads and ef_state is not None:
            grads, new_ef, qerr = compress_decompress(grads, ef_state, lay.across)
            metrics["compression_err"] = qerr
        params, opt_state, gnorm = adamw_update(params, grads, opt_state, opt_cfg,
                                                across=lay.across)
        metrics.update(loss=lay.loss_sum(torch.stack(losses)).mean(),
                       tokens=torch.stack(counts).sum(), grad_norm=gnorm,
                       step=opt_state.step)
        out = (params, opt_state, metrics)
        return out + ((new_ef,) if compress_grads else ())

    return train_step


def _fsdp_dim(spec, axis: Optional[str]) -> Optional[int]:
    """The dim ``spec`` shards over the FSDP ``axis``, or None."""
    for d, e in enumerate(spec):
        if axis is not None and axis in (e if isinstance(e, tuple) else (e,)):
            return d
    return None


def _tp_partial_flags(cfg: ModelConfig, specs: Dict[str, Any], tp: int,
                      seq_len: int):
    """``specs``' tree with True at the leaves replicated over TP whose
    per-rank gradient is partial (each mixer's ``tp_partial``, the MoE
    router's by ``seq_len``), False elsewhere."""
    attn = attention.tp_partial(cfg, tp)
    partial = {"attn": attn, "local": attn}
    if cfg.mla is not None:
        partial["mla"] = mla.tp_partial(cfg, tp)
    if cfg.ssm is not None:
        partial["ssm"] = ssm.tp_partial(cfg, tp)
    router = moe.tp_partial(cfg, tp, seq_len) if cfg.moe is not None else ()
    flags = _map_specs(lambda s: False, specs)
    for part, blocks in (("prelude", cfg.prelude), ("body", cfg.pattern),
                         ("postlude", cfg.postlude)):
        for tree, blk in zip(flags[part], blocks):
            for n in partial.get(blk.mixer, ()):
                tree["mixer"][n] = True
            if blk.ffn == "moe":
                for n in router:
                    tree["ffn"][n] = True
    return flags


def _fsdp_shards(params: Dict[str, Any], leaves: Dict[str, Any], specs: Dict[str, Any],
                 axis: str, group, zero1: bool = False) -> Dict[str, Any]:
    """``leaves`` (the tree of ``params``' masters, or views of them) with
    each leaf that ``specs`` cut over the FSDP ``axis`` a :class:`Shard` (a
    stacked body leaf one per period), gathered where the model uses it;
    with ``zero1`` each carries its master's gather in the compute type,
    made here."""
    def wrap(k):
        def fn(p, v, spec):
            d = _fsdp_dim(spec, axis)
            if d is None:
                return v
            full = None
            if zero1:
                with torch.no_grad():
                    full = all_gather(p.to(COMPUTE_DTYPE), group, d)
            if k != "body":
                return Shard(v, d, group, full)
            return Periods(Shard(x, d - 1, group, None if full is None else full[i])
                           for i, x in enumerate(v))
        return fn

    return {k: tree_map(wrap(k), params[k], leaves[k], specs[k]) for k in params}


class _Layout:
    """Where the train step's work lies on ``mesh``: this rank's rows of a
    microbatch, its FSDP leaves, the axes each gradient is summed over.
    Without a mesh every rule is the one-card step's: all rows, whole
    leaves, nothing reduced.  An axis of one rank costs nothing: a block
    over it is the whole leaf, so its leaves stay plain tensors."""

    def __init__(self, cfg: ModelConfig, rows_per_mb: int, seq_len: int, mesh,
                 zero1: bool):
        self.mesh, self.zero1 = mesh, zero1
        self.rows, self.replicas = slice(None), 1
        self.ctx = self.across = self.fsdp_axis = self.fsdp_group = None
        self.specs, self.axes, self.loss_axes = None, None, ()
        if mesh is None:
            return
        self.cfg = cfg
        sizes = mesh_shape(mesh)
        dp_axes = tuple(a for a in ("pod", "data") if sizes.get(a, 1) > 1)
        dp = make_ctx(mesh).dp_size()
        if rows_per_mb % dp:  # every data rank runs the whole microbatch
            self.replicas = dp
        elif dp > 1:  # each data rank its own rows, in (pod, data) order
            row0 = 0
            for a in dp_axes:
                row0 = row0 * sizes[a] + mesh.get_local_rank(a)
            n = rows_per_mb // dp
            self.rows, self.loss_axes = slice(row0 * n, (row0 + 1) * n), dp_axes
        self.ctx = dataclasses.replace(make_ctx(mesh), zero1=zero1,
                                       row_axes=self.loss_axes)
        _, fsdp, _ = mesh_axes(mesh)
        if fsdp is not None and sizes[fsdp] > 1:
            self.fsdp_axis, self.fsdp_group = fsdp, mesh.get_group(fsdp)
        self.specs = param_pspecs(cfg, mesh)
        spec_list = spec_leaves(self.specs)
        partial = tree_leaves(_tp_partial_flags(cfg, self.specs, self.ctx.tp_size(),
                                                seq_len))
        tp = ("model",) if sizes.get("model", 1) > 1 else ()
        # FSDP leaves were reduce-scattered over the FSDP axis in backward;
        # a leaf each TP rank used in part sums over TP too
        self.axes = [tuple(a for a in dp_axes if _fsdp_dim(sp, self.fsdp_axis) is None
                           or a != self.fsdp_axis) + (tp if pt else ())
                     for sp, pt in zip(spec_list, partial)]
        self.across = LeafReducer(mesh, [spec_axes(sp) for sp in spec_list])

    def shards(self, params: Dict[str, Any], leaves: Dict[str, Any]) -> Dict[str, Any]:
        """``leaves`` (:func:`autograd_leaves` of ``params``) with each FSDP
        leaf a :class:`Shard`; with ``zero1`` its bf16 weight is gathered
        here, once a step, in the TP-only layout."""
        if self.fsdp_axis is None:
            return leaves
        return _fsdp_shards(params, leaves, self.specs, self.fsdp_axis,
                            self.fsdp_group, self.zero1)

    def tp_group(self, unembed: torch.Tensor):
        """The loss's TP group: vocab-parallel where ``unembed`` is cut."""
        if self.ctx is None:
            return None
        return self.ctx.tp_group(unembed.shape[-1], self.cfg.vocab)

    def n_total(self, labels: torch.Tensor) -> Optional[torch.Tensor]:
        """The microbatch's valid tokens over every rank (None: the loss
        counts its own, which are all of them)."""
        if self.mesh is None:
            return None
        return torch.clamp((labels >= 0).sum(), min=1)

    def reduce_grads(self, grads: Dict[str, Any], n_mb: int) -> None:
        """Sum each accumulated gradient over the axes its backward did not,
        then average it over the microbatches (and over the data ranks that
        all ran the same rows), in place."""
        flat = tree_leaves(grads)
        for g, axes in zip(flat, self.axes or [()] * len(flat)):
            for a in axes:
                dist.all_reduce(g, group=self.mesh.get_group(a))
            g.div_(n_mb * self.replicas)

    def loss_sum(self, losses: torch.Tensor) -> torch.Tensor:
        """Each microbatch's loss over the ranks that split its rows."""
        for a in self.loss_axes:
            dist.all_reduce(losses, group=self.mesh.get_group(a))
        return losses


class _ServeLayout:
    """Where the serving steps' work lies on ``mesh`` (None: one card):
    their mesh context and which leaves arrive cut over FSDP.  Each rank
    holds its shards of the parameters (``param_pspecs``, TP-only without
    ``param_fsdp``), its block of the batch's rows over the data axes
    (``batch_entry``; every rank the whole batch where they do not divide
    it) and its blocks of the cache (``cache_pspecs``)."""

    def __init__(self, cfg: ModelConfig, batch: int, mesh, param_fsdp: bool,
                 cache_len: Optional[int] = None):
        self.ctx, self.fsdp = None, None
        if mesh is None:
            return
        sizes = mesh_shape(mesh)
        dp, fsdp, _ = mesh_axes(mesh)
        rows = tuple(a for a in dp if sizes[a] > 1) if batch_entry(mesh, batch) else ()
        self.ctx = dataclasses.replace(make_ctx(mesh), zero1=not param_fsdp,
                                       row_axes=rows, cache_len=cache_len)
        if param_fsdp and fsdp is not None and sizes[fsdp] > 1:
            self.fsdp = (fsdp, mesh.get_group(fsdp), param_pspecs(cfg, mesh))

    def weights(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """``params`` with each leaf cut over FSDP a :class:`Shard` (a
        stacked body leaf one per period), gathered layer by layer where
        the model uses it."""
        if self.fsdp is None:
            return params
        axis, group, specs = self.fsdp
        return _fsdp_shards(params, params, specs, axis, group)


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig,
                      cache_len: Optional[int] = None, mesh=None,
                      param_fsdp: bool = True) -> Callable:
    """The prefill step ``(params, batch) -> (logits, caches)``: the
    softcapped f32 logits of each sequence's last token, ``(B, V)``, and
    the cache tree of ``forward(collect_cache=True)``, ``cache_len`` rows
    long (default: the prompt's; more leaves decode headroom).  It runs
    where ``params`` and the batch's ``tokens`` lie, in the weights' own
    type.

    With ``mesh`` (a ``DeviceMesh``; one process per rank) ``params`` are
    this rank's shards by ``param_pspecs(cfg, mesh)`` (TP-only,
    ``fsdp=None``, without ``param_fsdp``), the batch this rank's block
    of rows (``input_shardings``), and the step returns this rank's rows
    of the logits and its blocks of the caches by ``cache_pspecs`` (at
    ``seq_len`` = the cache's length): the KV and MLA caches cut on the
    sequence over TP, the SSM state by heads, the conv windows and the
    RG-LRU state by channels.  A (1, 1) mesh computes as one card."""
    lay = _ServeLayout(cfg, shape.global_batch, mesh, param_fsdp)

    def prefill_step(params: Dict[str, Any], batch: Dict[str, Any]):
        params = lay.weights(params)
        ctx = lay.ctx
        if ctx is not None:  # the caches' rows, laid out by cache_pspecs
            seq = sum(batch[k].shape[1] for k in ("tokens", "patches", "frames")
                      if k in batch)
            ctx = dataclasses.replace(ctx, cache_len=cache_len or seq)
        h, _aux, caches = forward(params, cfg, batch, collect_cache=True,
                                  cache_len=cache_len, ctx=ctx)
        return logits_fn(params, cfg, h[:, -1], ctx), caches

    return prefill_step


def make_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                     greedy: bool = True, param_fsdp: bool = True,
                     quant_cache: bool = False) -> Callable:
    """The greedy decode step ``(params, tokens (B, 1), cache, t) ->
    (next tokens (B, 1) int32, cache)``: one ``decode_step`` at position
    ``t`` (the cache's layers are written in place) and the argmax of its
    logits.  ``cache`` is what the prefill step or ``init_cache`` gives
    (``quant_cache``: its int8 form, ``init_cache(quant_attn=True)``),
    ``shape.seq_len`` rows long.  ``greedy`` is ignored: it is the
    reference's keyword, whose step takes the argmax either way too.

    With ``mesh``, ``params``, the tokens and the cache are this rank's
    shards, rows and blocks as for :func:`make_prefill_step` (the cache's
    specs ``cache_pspecs(cfg, shape, mesh, quant_cache)``), and so is
    what the step returns.  A (1, 1) mesh computes as one card."""
    lay = _ServeLayout(cfg, shape.global_batch, mesh, param_fsdp, shape.seq_len)

    def serve_step(params: Dict[str, Any], tokens: torch.Tensor,
                   cache: Dict[str, Any], t: int):
        logits, new_cache = decode_step(lay.weights(params), cfg, tokens, cache, t,
                                        lay.ctx)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], new_cache

    return serve_step


def make_step(cfg: ModelConfig, shape: ShapeConfig, **kw) -> Callable:
    """The step of ``shape.kind``: "train", "prefill", or else decode
    (``mesh``, ``param_fsdp`` and the other keywords passed through)."""
    if shape.kind == "train":
        return make_train_step(cfg, shape, **kw)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape, **kw)
    return make_decode_step(cfg, shape, **kw)
