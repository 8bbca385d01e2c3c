"""Mixture-of-Experts FFN: top-k routing and capacity-packed experts.

The port of ``repro/models/moe.py`` for one card: its dense path
(``moe_apply_dense``), the oracle that its dispatcher takes when there is
no mesh.  The expert-parallel paths (``moe_apply_a2a``,
``moe_apply_gather``: ``shard_map`` over a TP axis) wait for sharding.

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
reduction in a fixed order, so two runs give the same bytes.

The backward is deterministic too.  Indexing with repeated indices
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
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.layers import mlp_apply, mlp_defs
from repro_torch.models.param import FSDP, TP, ParamDef

__all__ = ["moe_defs", "moe_apply", "moe_apply_dense"]


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


def _route(xf: torch.Tensor, router: torch.Tensor, m: MoEConfig):
    """Top-k routing.  Returns (weights (N, k) f32, experts (N, k) int64,
    aux).  The top k are taken by a stable descending sort, so equal
    probabilities rank by expert id, as ``jax.lax.top_k`` ranks them."""
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, : m.top_k], idx[:, : m.top_k]
    if m.normalize_top_k:
        w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
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
):
    """Sort-based capacity packing.  Returns (order, grp_sorted, pos, keep):
    the stable order by group, the sorted group ids, each sorted entry's
    position in its group's run, and whether it fits the capacity."""
    order = torch.argsort(groups, stable=True)
    gs = groups[order]
    starts = torch.searchsorted(
        gs, torch.arange(n_groups + 1, dtype=gs.dtype, device=gs.device))
    pos = torch.arange(groups.shape[0], device=gs.device) \
        - starts[torch.clamp(gs, max=n_groups)]
    keep = (pos < capacity) & (gs < n_groups)
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


def moe_apply_dense(
    p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-packed per-expert compute on one device.  x: (B, T, D) ->
    (out (B, T, D), aux loss)."""
    m = cfg.moe
    B, T, D = x.shape
    N = B * T
    k, E = m.top_k, m.n_experts
    xf = x.reshape(N, D)
    w, idx, aux = _route(xf, p["router"], m)
    M = N * k
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
    if m.n_shared:
        out = out + mlp_apply(p["shared"], x, cfg.act)
    return out, aux


def moe_apply(
    p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN on one device: the dense path, as the reference's
    dispatcher takes it with no mesh."""
    return moe_apply_dense(p, x, cfg)
