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
out-of-range indices; here they are written to a spare slot that no
expert runs).  Every expert runs
its whole ``(capacity, D)`` buffer as one batched gated FFN.

The combine differs in one way: the reference scatter-adds each entry
into its token (``contrib.at[tok].add``), which on CUDA would be
``index_add_`` with atomics in no fixed order.  Here each token's ``k``
contributions are gathered to ``(N, k, D)`` and summed over ``k``, one
reduction in a fixed order, so two runs give the same bytes.

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
    tok = torch.arange(N, device=x.device).repeat_interleave(k)
    cap = max(1, int(math.ceil(M / E * m.capacity_factor)))
    order, gs, pos, keep = _pack_by_group(idx.reshape(M), E, cap)
    # dropped entries all go to a spare slot `cap` that no expert runs (a
    # mask by index, not by a boolean selection: no device-to-host sync)
    gx = torch.zeros((E, cap + 1, D), dtype=x.dtype, device=x.device)
    gx[gs, torch.where(keep, pos, cap)] = xf[tok[order]]
    y = _expert_ffn(gx[:, :cap], p["w_gate"], p["w_up"], p["w_down"], cfg.act)
    # each sorted entry's output (0 where dropped), back in (token, slot)
    # order, weighted, and summed over a token's k slots in a fixed order
    vals = torch.where(keep[:, None], y[gs, torch.clamp(pos, max=cap - 1)],
                       torch.zeros((), dtype=y.dtype, device=y.device))
    per_slot = torch.empty_like(vals)
    per_slot[order] = vals
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
