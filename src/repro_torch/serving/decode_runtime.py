"""A ``StatefulFunction``-compatible decode wrapper over the KV pager.

The function state is ``{session, t, tok}`` (a few hundred bytes, cheap
to journal every commit) while the cache itself lives in the pager as
per-(layer, block) tier keys.

Each step reads the session's layer list through :meth:`KVPager.load`
(the resident handle when hot — no tier I/O), runs ``decode_step``, and
writes back only the dirty blocks.  Dispatch to the int8 path is
structural: a session that was demoted quantized comes back as
:class:`QuantAttnCache` leaves, which ``attn_decode`` routes to
``quant_decode_attention``; raw sessions take the decode kernel.  The
prefill runs the flash kernel (the SSD kernel for Mamba-2 blocks).  The
recurrent mixers (Mamba-2, RG-LRU) decode in their recurrent form, and
MLA in its absorbed form over the latent cache; the pager stores their
caches' tensors (conv window and state, latents and rotary keys) whole,
every step, as the reference does.  Both run on the pager's device: prompts
and journaled tokens are moved there, and resumed layers are placed there
by the pager.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch

from repro_torch.core.stateful import StatefulFunction
from repro_torch.models.attention import AttnCache
from repro_torch.models.convert import to_tensor
from repro_torch.models.quant_cache import QuantAttnCache
from repro_torch.models.transformer import decode_step, forward, init_cache, logits_fn
from repro_torch.serving.kvpager import KVPager

__all__ = ["PagedDecoder", "flatten_cache", "unflatten_cache"]

_LEAF = "*"


def _is_layer(x: Any) -> bool:
    return isinstance(x, (AttnCache, QuantAttnCache, torch.Tensor))


def flatten_cache(cache: Any) -> Tuple[List[Any], Any]:
    """Cache tree → flat list of per-layer caches + its structure, in the
    reference's pytree order (dict keys sorted, NamedTuple fields in
    order).  Attention caches stay whole (one pager layer each — the
    stacked body caches ride as single leaves with a leading period axis);
    other NamedTuples (``SSMCache``, ``RGLRUCache``, ``MLACache``) are
    nodes whose bare tensors (recurrent state, conv window, latents) are
    opaque leaves the pager stores whole.  The structure records each node's type, so
    :func:`unflatten_cache` rebuilds a NamedTuple as its own class."""
    layers: List[Any] = []

    def walk(x: Any) -> Any:
        if _is_layer(x):
            layers.append(x)
            return _LEAF
        if isinstance(x, dict):
            keys = sorted(x)
            return ("d", tuple(keys), tuple(walk(x[k]) for k in keys))
        if isinstance(x, (list, tuple)):
            return (type(x), tuple(walk(v) for v in x))
        raise TypeError(f"not a cache tree node: {type(x).__name__}")

    return layers, walk(cache)


def unflatten_cache(treedef: Any, layers: List[Any]) -> Any:
    it = iter(layers)

    def build(spec: Any) -> Any:
        if spec == _LEAF:
            return next(it)
        if spec[0] == "d":
            return {k: build(c) for k, c in zip(spec[1], spec[2])}
        kind, children = spec[0], [build(c) for c in spec[1]]
        if kind is list:
            return children
        return kind(*children) if hasattr(kind, "_fields") else kind(children)

    return build(treedef)


class PagedDecoder:
    """Builds the paged decode :class:`StatefulFunction`.

    ``fn`` is registered with ``jit=False``: the step does pager/tier I/O
    around the model math (prefill forward, decode step), which runs on
    ``pager.device``.
    """

    def __init__(
        self,
        params: Any,
        cfg: Any,
        pager: KVPager,
        *,
        prompt_len: int,
        max_tokens: int,
        name: str = "decode",
    ) -> None:
        self.params = params
        self.cfg = cfg
        self.pager = pager
        self.device = pager.device
        self.prompt_len = prompt_len
        self.total_len = prompt_len + max_tokens
        # Structure constant: the cache tree does not depend on batch size
        # or values, so a throwaway template (meta tensors: no memory)
        # recovers it even when this process never ran the prefill
        # (post-restart resume).
        _, self._treedef = flatten_cache(init_cache(cfg, 1, 2, device="meta"))
        self.fn = StatefulFunction(name, self._step, init=self._init,
                                   jit=False)

    # -- prefill ------------------------------------------------------------
    @torch.no_grad()
    def _init(self, session: str, prompt: Any) -> dict:
        prompt = to_tensor(prompt, self.device)
        plen = int(prompt.shape[1])
        h, _aux, kv = forward(self.params, self.cfg, {"tokens": prompt},
                              collect_cache=True, cache_len=self.total_len)
        logits = logits_fn(self.params, self.cfg, h[:, -1])
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        layers, _ = flatten_cache(kv)
        self.pager.create(session, layers, plen - 1)
        return {"session": session, "t": plen - 1, "tok": tok}

    # -- one decode token ---------------------------------------------------
    @torch.no_grad()
    def _step(self, state: dict) -> Tuple[dict, torch.Tensor]:
        sid = state["session"]
        layers, _t_meta = self.pager.load(sid)
        cache = unflatten_cache(self._treedef, layers)
        t = int(state["t"]) + 1
        tok = to_tensor(state["tok"], self.device)
        logits, new_cache = decode_step(self.params, self.cfg, tok, cache, t)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        new_layers, _ = flatten_cache(new_cache)
        self.pager.write(sid, new_layers, t)
        return {"session": sid, "t": t, "tok": tok}, tok
