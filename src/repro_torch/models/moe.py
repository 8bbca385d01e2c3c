"""Mixture-of-Experts FFN: top-k routing and capacity-packed experts.

The port of ``repro/models/moe.py``.  Three apply paths, picked by
``moe_apply`` with the reference's rules:

  * ``moe_apply_dense``   — every token through its top-k experts on one
    device; the oracle, and the path with no mesh.
  * ``moe_apply_a2a``     — expert parallelism over the mesh's TP axis:
    tokens sequence-sharded over TP, two ``all_to_all_single`` calls
    (dispatch and return).  Used for train/prefill.
  * ``moe_apply_gather``  — expert parallelism for tiny T (decode): tokens
    replicated over TP, each TP rank computes its own experts, and one
    all-reduce sums them.

EP dispatch *is* the paper's shuffle (``core/device_shuffle.py``): tokens
are intermediate data routed to their owner, the expert.  The reference
writes the sharded paths as ``shard_map`` bodies; here each rank runs the
body on its block with the collectives over the mesh axes' process
groups, each an autograd Function (``parallel.collectives``), so every
path trains.  Called on their own, the sharded paths take the whole
``x``, replicated on every rank, work on the rank's block as the
reference's ``in_specs`` lay it out, and all-gather their output back to
``(B, T, D)``; each rank holds only its ``E/tp`` experts, sliced over the
last data axis too unless ``zero1`` (:func:`shard_params` cuts them), and
gathers the FSDP slices inside the layer, as the reference's manual
ZeRO-3 gather does.  In the sharded train step (``row_axes``) each rank
already holds its own rows of the microbatch and its experts gathered
over FSDP, so the layer neither blocks nor gathers over the data axes.
There the dense path, on data axes of more than one rank, routes the
whole microbatch, as the reference's GSPMD layout of it does
(:func:`_route_global`): only the per-expert entry counts and the
probabilities' sums cross the ranks.

The dispatch is the reference's, so the same tokens reach the same
experts and the same ones are dropped: a stable sort of the (token, slot)
entries by expert, each entry's position in its expert's run, and a
capacity of ``ceil(N·k / E · capacity_factor)`` slots per expert; entries
past it are dropped (the reference's ``.at[...].set(mode="drop")`` with
out-of-range indices; here they are written to a spare row past the
experts' slots, which no expert runs).  Every expert runs
its whole ``(capacity, D)`` buffer as one batched gated FFN.

The combine differs in one way: the reference scatter-adds each entry
into its token (``contrib.at[tok].add``), which on CUDA would be
``index_add_`` with atomics in no fixed order.  Here each token's ``k``
contributions are gathered to ``(N, k, D)`` and summed over ``k``, one
reduction in a fixed order, so two runs give the same bytes (the sharded
paths combine the same way).

The backward of the dense path is deterministic too.  Indexing with repeated indices
(``xf[tok[order]]`` repeats each token ``k`` times; the dropped entries
all read one slot) would accumulate its gradient into the repeats, on
CUDA with atomics in no fixed order.  So the two moves, tokens into the
experts' slots and the experts' rows back to (token, slot) order, are
:class:`_Dispatch` and :class:`_Combine`: their forwards are the plain
index-and-scatter (``order`` is a permutation, so each scatter writes a
row once, bar the dropped entries' spare row), and their backwards
invert the same map, each kept entry owning one slot, with a token's
``k`` slots summed in a fixed order.  The gradient reaches the kept
entries and, through the combine weights, the router's softmax, as
``jax.value_and_grad`` gives it.

At decode (``N = 1``) the capacity is 1 and every expert computes one
slot, mostly empty: every expert's weights are read on every token, as in
the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.layers import mlp_apply, mlp_defs
from repro_torch.models.param import FSDP, TP, ParamDef
from repro_torch.parallel.collectives import (
    all_gather, all_to_all, copy_to_tp, gather_from_tp, gather_shard, mesh_axis,
    reduce_from_tp)

__all__ = ["moe_defs", "moe_apply", "moe_apply_dense", "moe_apply_a2a",
           "moe_apply_gather", "shard_params", "tp_partial"]


def moe_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    m = cfg.moe
    D, E, Fe = cfg.d_model, m.n_experts, m.d_expert
    defs = {
        "router": ParamDef((D, E), (FSDP, None), dtype=torch.float32),
        "w_gate": ParamDef((E, D, Fe), (TP, FSDP, None)),
        "w_up": ParamDef((E, D, Fe), (TP, FSDP, None)),
        "w_down": ParamDef((E, Fe, D), (TP, None, FSDP)),
    }
    if m.n_shared:
        defs["shared"] = mlp_defs(D, m.n_shared * Fe, gated=True)
    return defs


def _top_k(xf: torch.Tensor, router: torch.Tensor, m: MoEConfig):
    """(probabilities (N, E) f32, weights (N, k) f32, experts (N, k)
    int64).  The top k are taken by a stable descending sort, so equal
    probabilities rank by expert id, as ``jax.lax.top_k`` ranks them."""
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, : m.top_k], idx[:, : m.top_k]
    if m.normalize_top_k:
        w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, w, idx


def _route(xf: torch.Tensor, router: torch.Tensor, m: MoEConfig):
    """Top-k routing (:func:`_top_k`).  Returns (weights (N, k) f32,
    experts (N, k) int64, aux)."""
    probs, w, idx = _top_k(xf, router, m)
    # load-balance aux (Switch-style): E * sum_e f_e * p_e
    E = probs.shape[-1]
    f = F.one_hot(idx, E).float().sum(dim=1).mean(dim=0)
    p = probs.mean(dim=0)
    aux = E * torch.sum(f * p)
    return w, idx, aux


def _expert_ffn(gx: torch.Tensor, wg, wu, wd, act: str) -> torch.Tensor:
    """gx: (E, C, D) -> (E, C, D); batched gated FFN, one product per
    weight over every expert."""
    if act == "silu":
        act_fn = F.silu
    else:
        act_fn = lambda y: F.gelu(y, approximate="tanh")  # noqa: E731
    h = act_fn(torch.bmm(gx, wg)) * torch.bmm(gx, wu)
    return torch.bmm(h, wd)


def _pack_by_group(
    groups: torch.Tensor,  # (M,) int group id, or a larger sentinel for none
    n_groups: int,
    capacity: int,
    ahead: Optional[torch.Tensor] = None,
):
    """Sort-based capacity packing.  Returns (order, grp_sorted, pos, keep):
    the stable order by group, the sorted group ids, each sorted entry's
    position in its group's run, and whether it fits the capacity.
    ``ahead`` (n_groups,) counts the entries queued in each group before
    these (earlier ranks' rows): an entry's place in the queue is that
    plus its position."""
    order = torch.argsort(groups, stable=True)
    gs = groups[order]
    starts = torch.searchsorted(
        gs, torch.arange(n_groups + 1, dtype=gs.dtype, device=gs.device))
    pos = torch.arange(groups.shape[0], device=gs.device) \
        - starts[torch.clamp(gs, max=n_groups)]
    queue = pos if ahead is None else pos + ahead[torch.clamp(gs, max=n_groups - 1)]
    keep = (queue < capacity) & (gs < n_groups)
    return order, gs, pos, keep


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` with the rows of an index past ``x``'s end read as zeros."""
    n = x.shape[0]
    out = x[torch.clamp(idx, max=n - 1)]
    return out.masked_fill_((idx >= n)[:, None], 0)


class _Dispatch(torch.autograd.Function):
    """Tokens into the experts' rows.  ``x`` (N, D); ``order`` the sorted
    entries (entry ``j`` is token ``j // k``); ``slot`` each sorted
    entry's row of the ``(n_slots, D)`` result, ``n_slots`` where it is
    dropped.  Rows no entry fills are zero.  The backward reads the
    gradient by the same map (zero for dropped entries), puts it back in
    entry order (``order`` is a permutation: each row written once) and
    sums a token's ``k`` entries in a fixed order."""

    @staticmethod
    def forward(ctx, x, order, slot, k: int, n_slots: int):
        ctx.save_for_backward(order, slot)
        ctx.k = k
        # the dropped entries all land in a spare last row, cut off
        buf = x.new_zeros((n_slots + 1, x.shape[1]))
        buf[slot] = x[torch.div(order, k, rounding_mode="floor")]
        return buf[:n_slots]

    @staticmethod
    def backward(ctx, g):
        order, slot = ctx.saved_tensors
        g_sorted = _rows(g, slot)
        g_entry = torch.empty_like(g_sorted)
        g_entry[order] = g_sorted
        return (g_entry.view(-1, ctx.k, g.shape[1]).sum(dim=1),
                None, None, None, None)


class _Combine(torch.autograd.Function):
    """The experts' rows ``y`` (n_slots, D) back in entry order: entry
    ``order[i]`` takes row ``slot[i]``, zero where dropped.  The backward
    writes each kept entry's gradient to its row, and zero to the rows no
    entry fills (the dropped entries all write a spare last row, cut
    off)."""

    @staticmethod
    def forward(ctx, y, order, slot):
        ctx.save_for_backward(order, slot)
        ctx.n_slots = y.shape[0]
        vals = _rows(y, slot)
        out = torch.empty_like(vals)
        out[order] = vals
        return out

    @staticmethod
    def backward(ctx, g):
        order, slot = ctx.saved_tensors
        gy = g.new_zeros((ctx.n_slots + 1, g.shape[1]))  # spare row as above
        gy[slot] = g[order]
        return gy[: ctx.n_slots], None, None


def _route_global(xf: torch.Tensor, router: torch.Tensor, m: MoEConfig, mesh,
                  row_axes: Tuple[str, ...]):
    """The reference's dense route of the whole microbatch, from this rank's
    block of its rows (``xf``, the ranks' blocks in ``row_axes`` order, the
    first the major one): one capacity over every token, each entry's
    place in its expert's queue in global (token, slot) order (the
    entries of the ranks before this one first), and the balance loss over
    every token.  Returns (weights, experts, aux, capacity, the pack of
    :func:`_pack_by_group`).  Only the per-expert entry counts cross the
    ranks, and the probabilities' sums: those through ``reduce_from_tp``,
    so each rank's gradient of the loss reaches its own rows."""
    probs, w, idx = _top_k(xf, router, m)
    E, M = probs.shape[-1], idx.numel()
    counts = torch.bincount(idx.reshape(M), minlength=E)[None]
    me = 0
    for a in row_axes:
        size, _, coord = mesh_axis(mesh, a)
        me = me * size + coord
    for a in reversed(row_axes):
        counts = all_gather(counts, mesh_axis(mesh, a)[1], 0)
    n_all = xf.shape[0] * counts.shape[0]  # tokens of the microbatch
    cap = max(1, int(math.ceil(n_all * m.top_k / E * m.capacity_factor)))
    pack = _pack_by_group(idx.reshape(M), E, cap, counts[:me].sum(dim=0))
    p_sum = probs.sum(dim=0)
    for a in row_axes:
        p_sum = reduce_from_tp(p_sum, mesh_axis(mesh, a)[1])
    f = counts.sum(dim=0).float() / n_all
    aux = E * torch.sum(f * (p_sum / n_all))
    return w, idx, aux, cap, pack


def moe_apply_dense(
    p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig, mesh=None,
    row_axes: Tuple[str, ...] = (), shared_group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-packed per-expert compute on one device.  x: (B, T, D) ->
    (out (B, T, D), aux loss).  With ``row_axes`` (axes of ``mesh``), ``x``
    is this rank's block of a microbatch's rows split over them, routed as
    the whole microbatch (:func:`_route_global`); each rank runs its own
    kept entries through the experts.  ``shared_group``: the TP group the
    shared expert's weights are cut over, or None."""
    m = cfg.moe
    B, T, D = x.shape
    N = B * T
    k, E = m.top_k, m.n_experts
    xf = x.reshape(N, D)
    M = N * k
    row_axes = tuple(a for a in row_axes if mesh_axis(mesh, a)[0] > 1)
    if row_axes:
        w, idx, aux, cap, (order, gs, pos, keep) = _route_global(
            xf, p["router"], m, mesh, row_axes)
    else:
        w, idx, aux = _route(xf, p["router"], m)
        cap = max(1, int(math.ceil(M / E * m.capacity_factor)))
        order, gs, pos, keep = _pack_by_group(idx.reshape(M), E, cap)
    # each sorted entry's row of the experts' (E·cap) slots, E·cap where
    # dropped (a mask by index, not by a boolean selection: no
    # device-to-host sync)
    slot = torch.where(keep, gs * cap + pos, E * cap)
    gx = _Dispatch.apply(xf, order, slot, k, E * cap).view(E, cap, D)
    y = _expert_ffn(gx, p["w_gate"], p["w_up"], p["w_down"], cfg.act)
    # each entry's output (0 where dropped) in (token, slot) order,
    # weighted, and summed over a token's k slots in a fixed order
    per_slot = _Combine.apply(y.reshape(E * cap, D), order, slot)
    per_slot = per_slot * w.reshape(M, 1).to(y.dtype)
    out = per_slot.reshape(N, k, D).sum(dim=1).reshape(B, T, D).to(x.dtype)
    return _add_shared(out, p, x, cfg, shared_group), aux


def _add_shared(out, p, x, cfg: ModelConfig, shared_group):
    if not cfg.moe.n_shared:
        return out
    return out + mlp_apply(p["shared"], x, cfg.act, shared_group)


# -- sharded paths ---------------------------------------------------------

def _block(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim``, split over ``axes`` (the
    first the major one), as a spec entry ``axes`` at ``dim`` lays it out."""
    idx, n = 0, 1
    for a in axes:
        size, _, coord = mesh_axis(mesh, a)
        idx, n = idx * size + coord, n * size
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over "
                         f"{tuple(axes)} ({n} ranks)")
    b = t.shape[dim] // n
    return t.narrow(dim, idx * b, b)


def _expert_parallel(mesh, tp_axis: str, n_experts: int) -> bool:
    """The reference's rule: experts are split over TP only with a TP axis
    of more than one rank that divides them; else the dense path runs."""
    if mesh is None or tp_axis not in mesh.mesh_dim_names:
        return False
    tp = mesh_axis(mesh, tp_axis)[0]
    return tp > 1 and n_experts % tp == 0


def tp_partial(cfg: ModelConfig, tp: int, seq_len: int) -> Tuple[str, ...]:
    """The leaves replicated over a TP axis of ``tp`` ranks whose gradient
    each rank computes only in part at sequence length ``seq_len``: the
    router on the a2a path, which routes each TP rank's own tokens."""
    if tp > 1 and cfg.moe.n_experts % tp == 0 and seq_len % tp == 0:
        return ("router",)
    return ()


def shard_params(p: Dict[str, torch.Tensor], mesh, dp_axes=("data",),
                 tp_axis: str = "model", zero1: bool = False):
    """This rank's slices of a MoE layer's full parameters, by the
    reference's ``in_specs``: the router over the last data axis on its
    rows, the experts over TP on the expert dim and over the last data
    axis on d_model (none of the data slicing with ``zero1``).  A stacked
    layer (a leading period axis) is cut the same way.  The shared expert
    stays whole, and so does everything where ``moe_apply`` runs the dense
    path."""
    lead = p["w_gate"].ndim - 3
    if not _expert_parallel(mesh, tp_axis, p["w_gate"].shape[lead]):
        return p
    fsdp = () if zero1 else tuple(dp_axes[-1:])
    tp = (tp_axis,)
    out = dict(p)
    out["router"] = _block(p["router"], mesh, fsdp, lead).clone()
    for name, fdim in (("w_gate", 1), ("w_up", 1), ("w_down", 2)):
        out[name] = _block(_block(p[name], mesh, tp, lead), mesh, fsdp,
                           lead + fdim).clone()
    return out


def _ep_inputs(p, x: torch.Tensor, mesh, dp_axes, tp_axis: str, zero1: bool,
               row_axes, router_over_tp: bool):
    """(this rank's rows of ``x``, the router, the experts' three weights,
    the data axes the rows are split over) for an expert-parallel path.

    In the train step (``row_axes`` given) ``x`` is already the rank's
    rows and the weights arrive gathered over FSDP.  Else ``x`` is the
    whole input on every rank and ``p`` holds :func:`shard_params`'s
    slices: the rank takes its block of rows, gathers the FSDP slices
    (``gather_shard``: the gradient reduce-scattered back), and the
    gradients of ``x`` and of the weights sum over the data ranks whose
    rows they served (over TP too for the router, ``router_over_tp``, when
    each TP rank routes its own tokens): ``copy_to_tp`` over those axes."""
    experts = (p["w_gate"], p["w_up"], p["w_down"])
    if row_axes is not None:
        return x, p["router"], experts, tuple(row_axes)
    fsdp = () if zero1 else tuple(dp_axes[-1:])
    others = tuple(a for a in dp_axes if a not in fsdp)
    for a in dp_axes:
        x = copy_to_tp(x, mesh_axis(mesh, a)[1])

    def whole(t, dim, over=()):
        for a in others + over:
            t = copy_to_tp(t, mesh_axis(mesh, a)[1])
        for a in fsdp:
            t = gather_shard(t, t.dtype, dim, mesh_axis(mesh, a)[1])
        return t

    router = whole(p["router"], 0, (tp_axis,) if router_over_tp else ())
    experts = tuple(whole(t, d) for t, d in zip(experts, (1, 1, 2)))
    return _block(x, mesh, dp_axes, 0), router, experts, tuple(dp_axes)


def _ep_output(out: torch.Tensor, mesh, dp_axes, row_axes) -> torch.Tensor:
    """The path's output for its caller: this rank's rows in the train step,
    else every rank's blocks gathered back to the whole (the backward keeps
    the rank's block: every rank computes the same loss from the whole)."""
    if row_axes is not None:
        return out
    for a in reversed(tuple(dp_axes)):
        out = gather_from_tp(out, mesh_axis(mesh, a)[1], 0)
    return out


def _aux_mean(aux: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean of the ranks' balance losses over ``axes``; each rank's
    gradient reaches its own share (``reduce_from_tp``)."""
    for a in axes:
        size, group, _ = mesh_axis(mesh, a)
        if size > 1:
            aux = reduce_from_tp(aux, group) / size
    return aux


def moe_apply_a2a(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cfg: ModelConfig,
    mesh,
    dp_axes: Tuple[str, ...],
    tp_axis: str,
    zero1: bool = False,
    row_axes: Optional[Tuple[str, ...]] = None,
    shared_group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """EP via two all-to-alls; tokens sequence-sharded along TP.  Without
    ``row_axes``, ``p`` holds this rank's slices (:func:`shard_params`)
    and ``x`` is the whole (B, T, D) input, and so is the output, on every
    rank; with them (the train step) ``x`` and the output are this rank's
    rows and ``p`` its experts gathered over FSDP (:func:`_ep_inputs`).
    Each TP rank routes its ``T/tp`` tokens: its slice of an input every
    TP rank holds whole, so the input's gradient sums over TP
    (``copy_to_tp``), and the slices' outputs are gathered back along
    ``T`` (``gather_from_tp``)."""
    m = cfg.moe
    B, T, D = x.shape
    k, E = m.top_k, m.n_experts
    tp, tp_group, my_col = mesh_axis(mesh, tp_axis)
    if E % tp or T % tp:
        raise ValueError(f"the a2a MoE path needs {E} experts and seq {T} "
                         f"divisible by TP {tp}")
    E_loc = E // tp
    xl, router, (wg, wu, wd), axes = _ep_inputs(p, x, mesh, dp_axes, tp_axis,
                                                zero1, row_axes, True)
    xl = _block(copy_to_tp(xl, tp_group), mesh, (tp_axis,), 1)
    Bl, Tl, _ = xl.shape
    N = Bl * Tl
    M = N * k
    xf = xl.reshape(N, D)
    w, idx, aux = _route(xf, router, m)
    e_flat = idx.reshape(M)
    cap_s = max(1, int(math.ceil(M / tp * m.capacity_factor)))
    cap_e = max(1, int(math.ceil(M * tp / E * m.capacity_factor)))

    # ---- dispatch pack (by owner column); dropped entries to a spare row
    order, gs, pos, keep = _pack_by_group(e_flat // E_loc, tp, cap_s)
    slot = torch.where(keep, gs * cap_s + pos, tp * cap_s)
    send_x = _Dispatch.apply(xf, order, slot, k, tp * cap_s)
    send_e = torch.full((tp * cap_s + 1,), -1, dtype=torch.int64, device=x.device)
    send_e[slot] = e_flat[order]
    recv_x = all_to_all(send_x, tp_group)
    recv_e = all_to_all(send_e[:-1], tp_group)

    # ---- local expert grouping
    le = torch.where(recv_e >= 0, recv_e - my_col * E_loc, E_loc)
    order2, gs2, pos2, keep2 = _pack_by_group(le, E_loc, cap_e)
    slot2 = torch.where(keep2, gs2 * cap_e + pos2, E_loc * cap_e)
    gx = _Dispatch.apply(recv_x, order2, slot2, 1, E_loc * cap_e)
    y = _expert_ffn(gx.view(E_loc, cap_e, D), wg, wu, wd, cfg.act)
    ret = _Combine.apply(y.reshape(E_loc * cap_e, D), order2, slot2).to(x.dtype)
    back = all_to_all(ret, tp_group)

    # ---- combine at source: each entry's row (0 where dropped), weighted,
    # summed over a token's k slots in a fixed order
    got = _Combine.apply(back, order, slot)
    out = (got * w.reshape(M, 1).to(got.dtype)).view(N, k, D).sum(dim=1)
    out = gather_from_tp(out.view(Bl, Tl, D), tp_group, 1)
    out = _ep_output(out, mesh, dp_axes, row_axes)
    aux = _aux_mean(aux, mesh, (tp_axis,) + axes)
    return _add_shared(out, p, x, cfg, shared_group), aux


def moe_apply_gather(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cfg: ModelConfig,
    mesh,
    dp_axes: Tuple[str, ...],
    tp_axis: str,
    zero1: bool = False,
    row_axes: Optional[Tuple[str, ...]] = None,
    shared_group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """EP for decode-size T: tokens replicated over TP, each TP rank runs
    its own experts, and an all-reduce over TP sums them.  ``p``, ``x``
    and ``row_axes`` as for :func:`moe_apply_a2a`.  Every TP rank routes
    the same tokens, so the router's gradient and the balance loss's are
    whole on each; the gradients its own experts give the tokens and the
    combine weights are its share, summed over TP (``copy_to_tp``)."""
    m = cfg.moe
    B, T, D = x.shape
    k, E = m.top_k, m.n_experts
    tp, tp_group, my_col = mesh_axis(mesh, tp_axis)
    if E % tp:
        raise ValueError(f"{E} experts do not split over TP {tp}")
    E_loc = E // tp
    xl, router, (wg, wu, wd), axes = _ep_inputs(p, x, mesh, dp_axes, tp_axis,
                                                zero1, row_axes, False)
    Bl = xl.shape[0]
    N = Bl * T
    M = N * k
    xf = xl.reshape(N, D)
    w, idx, aux = _route(xf, router, m)
    le = idx.reshape(M) - my_col * E_loc
    le = torch.where((le >= 0) & (le < E_loc), le, E_loc)
    cap_e = max(1, int(math.ceil(M / E * m.capacity_factor)))
    order, gs, pos, keep = _pack_by_group(le, E_loc, cap_e)
    slot = torch.where(keep, gs * cap_e + pos, E_loc * cap_e)
    gx = _Dispatch.apply(copy_to_tp(xf, tp_group), order, slot, k, E_loc * cap_e)
    y = _expert_ffn(gx.view(E_loc, cap_e, D), wg, wu, wd, cfg.act)
    per = _Combine.apply(y.reshape(E_loc * cap_e, D), order, slot)
    per = per * copy_to_tp(w, tp_group).reshape(M, 1).to(per.dtype)
    contrib = reduce_from_tp(per.view(N, k, D).sum(dim=1), tp_group)
    out = _ep_output(contrib.view(Bl, T, D).to(x.dtype), mesh, dp_axes, row_axes)
    aux = _aux_mean(aux, mesh, axes)
    return _add_shared(out, p, x, cfg, shared_group), aux


def moe_apply(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cfg: ModelConfig,
    mesh=None,
    dp_axes: Tuple[str, ...] = ("data",),
    tp_axis: str = "model",
    zero1: bool = False,
    row_axes: Optional[Tuple[str, ...]] = None,
    shared_group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatching wrapper, the reference's rules: dense with no mesh, no
    TP axis, TP 1 or experts that TP does not divide; a2a when TP divides
    the sequence; gather otherwise.  ``p`` is what :func:`shard_params`
    gives for the same mesh, or with ``row_axes`` the train step's layout
    (:class:`~repro_torch.models.ctx.ShardCtx`'s ``row_axes``), where
    the dense path routes the whole microbatch over them."""
    if not _expert_parallel(mesh, tp_axis, cfg.moe.n_experts):
        return moe_apply_dense(p, x, cfg, mesh, row_axes or (), shared_group)
    path = moe_apply_a2a if x.shape[1] % mesh_axis(mesh, tp_axis)[0] == 0 \
        else moe_apply_gather
    return path(p, x, cfg, mesh, dp_axes, tp_axis, zero1, row_axes, shared_group)
