"""AdamW, global-norm clipping and a cosine schedule over trees of tensors.

The port of ``repro/optim/adamw.py``.  The arithmetic is the reference's,
in f32, including the bias corrections ``1 - b**step`` as f32 powers of
the integer step.  The reference returns new arrays; here the update
writes the parameters, both moments and the (clipped) gradients in place
and returns the same tensors, since at full width a second copy of the
f32 masters and moments does not fit on the card beside the first (3.4 B
parameters: 13.6 GB of masters, 27.2 GB of moments).  Large leaves are
updated in slices, so a step's temporaries stay small.  Parameters are
stored f32 and cast to the compute type inside the step.

On a mesh each rank updates its own shards of the parameters, moments and
gradients; the global norm takes ``across`` (a
:class:`~repro_torch.parallel.collectives.LeafReducer`), which sums each
leaf's squares over the ranks its shards lie on, so every element counts
once.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "clip_by_global_norm"]

#: elements per slice of a leaf's in-place update (64 M: 256 MB of f32)
SLICE = 1 << 26


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0


class OptState(NamedTuple):
    mu: Any  # first moment, f32, a tree like the params
    nu: Any  # second moment, f32, a tree like the params
    step: torch.Tensor  # scalar int32


def adamw_init(params: Any) -> OptState:
    """Zero moments beside each parameter, step 0 on the first leaf's
    device."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return OptState(
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def global_norm(tree: Any, across=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32, summed in leaf
    order; with ``across``, each leaf's squares summed over its shards
    first."""
    squares = [torch.linalg.vector_norm(leaf, dtype=torch.float32).square()
               for leaf in tree_leaves(tree)]
    if not squares:
        return torch.zeros((), dtype=torch.float32)
    if across is not None:
        squares = across.sum(squares)
    total = squares[0]
    for sq in squares[1:]:
        total = total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Any, max_norm: float, in_place: bool = False,
                        across=None) -> Tuple[Any, torch.Tensor]:
    """Scale ``grads`` to global norm at most ``max_norm``; returns (the
    scaled tree, the norm before scaling).  ``in_place`` scales the given
    tensors; ``across`` as for :func:`global_norm`."""
    norm = global_norm(grads, across)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    if in_place:
        for g in tree_leaves(grads):
            g.mul_(scale)
        return grads, norm
    return tree_map(lambda g: g * scale, grads), norm


def _slices(t: torch.Tensor):
    flat = t.view(-1)
    return flat.split(SLICE) if flat.numel() > SLICE else (flat,)


def adamw_update(
    params: Any,
    grads: Any,
    state: OptState,
    cfg: AdamWConfig,
    lr: Optional[Union[float, torch.Tensor]] = None,
    across=None,
) -> Tuple[Any, OptState, torch.Tensor]:
    """One AdamW step, in place on ``params``, ``state``'s moments and
    ``grads`` (clipped when ``cfg.grad_clip`` is set).  Returns
    ``(params, new_state, grad_norm)``: the same parameter and moment
    tensors, a new step count, and the norm before clipping (global over
    the shards with ``across``, as for :func:`global_norm`)."""
    if cfg.grad_clip is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, in_place=True,
                                           across=across)
    else:
        gnorm = global_norm(grads, across)
    step = state.step + 1
    lr_t = cfg.lr if lr is None else lr
    s32 = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=s32.device), s32)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=s32.device), s32)
    flat_p = tree_leaves(params)
    for p, g, m, v in zip(flat_p, tree_leaves(grads), tree_leaves(state.mu),
                          tree_leaves(state.nu)):
        if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()
                and g.is_contiguous()):
            raise ValueError("adamw_update works in place on contiguous leaves")
        for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m), _slices(v)):
            g32 = gs.float()
            ms.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
            vs.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
            delta = (ms / b1c) / (torch.sqrt(vs / b2c) + cfg.eps)
            p32 = ps.float()
            ps.copy_(p32 - lr_t * (delta + cfg.weight_decay * p32))
    return params, OptState(state.mu, state.nu, step), gnorm


def cosine_schedule(
    base_lr: float, warmup: int, total: int, min_frac: float = 0.1
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_frac * base_lr`` at ``total``; a function of the
    (tensor) step, in f32."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = base_lr * torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup, warm, cos)

    return lr
