"""Session-granular paged KV-cache layout over the tier hierarchy.

The paper's thesis — function state resident in a PMEM-backed fast tier
instead of reloaded from slow storage — applied to the highest-traffic
stateful workload there is: LM decode KV caches.  A conversation's cache
is cut into fixed-size token blocks (the lite_llama-style ``(B, S, Kv,
dh)`` layout sliced along ``S``), one tier key per (session, layer,
block), so the hierarchy can place each session independently:

  * **hot** — the session's block prefix is pinned in the fast (DRAM)
    level via :meth:`TieredStore.pin`; every decode step writes back only
    the block containing the slot it touched.
  * **cold** — a warm-pool eviction routes through :meth:`demote`: blocks
    are re-encoded as int8 (``quantize_kv`` — per-(position, head) scales,
    ~4x smaller than bf16) and pushed one level down to the PMEM home.
    ``lossless=True`` demotes the raw bytes instead, for byte-identity
    guarantees (and tests).
  * **resuming** — :meth:`resume` re-pins lazily and hands the block list
    to :meth:`TieredStore.promote_async`, so a returning session's blocks
    climb back to DRAM on the prefetch worker *ahead of* its next decode
    step; ``prefetch=False`` keeps the demand-fault behaviour for
    comparison (the fig10 resume-TTFT contrast).

The pager is deliberately ignorant of transformer structure: it pages a
flat list of per-layer caches (:class:`AttnCache` /
:class:`QuantAttnCache` / opaque array leaves for the recurrent mixers'
states and MLA's latents);
``decode_runtime`` owns the flatten/unflatten against the model's cache
tree.

Blocks come back from the tiers as host arrays; the pager joins each
layer and places it on its ``device`` (the decoder's), so a resumed or
demoted session decodes on the card, never on host copies.  Block blobs
use the reference's layout: a session paged by the reference package
resumes here.
"""

from __future__ import annotations

import itertools
import json
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.models.attention import AttnCache
from repro_torch.models.convert import to_tensor
from repro_torch.models.quant_cache import QuantAttnCache, quantize_cache
from repro_torch.storage import serde

__all__ = ["KVPager", "PagerStats"]

#: per-layer kinds recorded in the session meta record
_ATTN, _QUANT, _OPAQUE = "attn", "quant", "opaque"


class PagerStats:
    """Cumulative pager counters (the fig10 observables)."""

    __slots__ = ("demotions", "resumes", "demand_faults", "quantized_blocks",
                 "blocks_written", "max_resident")

    def __init__(self) -> None:
        self.demotions = 0
        self.resumes = 0
        self.demand_faults = 0
        self.quantized_blocks = 0
        self.blocks_written = 0
        self.max_resident = 0

    def as_dict(self) -> Dict[str, int]:
        return {name: getattr(self, name) for name in self.__slots__}


class _Session:
    __slots__ = ("sid", "t", "resident", "hot", "quantized", "sizes",
                 "last_touch", "lock")

    def __init__(self, sid: str) -> None:
        self.sid = sid
        self.t = -1
        #: in-process handle on the assembled layer list while hot (the
        #: per-token fast path — no reassembly between steps).  The tier
        #: blocks stay the source of truth; this is dropped on demote.
        self.resident: Optional[List[Any]] = None
        self.hot = False
        self.quantized = False
        self.sizes: Dict[str, int] = {}
        self.last_touch = 0
        self.lock = threading.RLock()

    @property
    def nbytes(self) -> int:
        return sum(self.sizes.values())


def _layer_kind(layer: Any) -> str:
    if isinstance(layer, QuantAttnCache):
        return _QUANT
    if isinstance(layer, AttnCache):
        return _ATTN
    return _OPAQUE


def _seq_len(layer: Any) -> int:
    arr = layer.k_q if isinstance(layer, QuantAttnCache) else layer.k
    return int(arr.shape[-3])


def _slice_block(layer: Any, lo: int, hi: int) -> Dict[str, Any]:
    """One (layer, block) blob: the block's token slots from every array
    of the layer cache.  Values/int8 carry the sequence axis at -3,
    quant scales at -2; opaque leaves are stored whole."""
    if isinstance(layer, QuantAttnCache):
        return {
            "k_q": layer.k_q[..., lo:hi, :, :],
            "v_q": layer.v_q[..., lo:hi, :, :],
            "k_s": layer.k_s[..., lo:hi, :],
            "v_s": layer.v_s[..., lo:hi, :],
        }
    if isinstance(layer, AttnCache):
        return {"k": layer.k[..., lo:hi, :, :], "v": layer.v[..., lo:hi, :, :]}
    return {"x": layer}


def _join_blocks(kind: str, parts: List[Dict[str, Any]], device: Any) -> Any:
    """One layer from its block blobs, joined on the host and moved to
    ``device`` in one copy per array."""
    if kind == _OPAQUE:
        return to_tensor(parts[0]["x"], device)
    cat = lambda name, axis: torch.cat(
        [to_tensor(p[name]) for p in parts], dim=axis
    ).to(device)
    if kind == _QUANT:
        return QuantAttnCache(
            k_q=cat("k_q", -3), v_q=cat("v_q", -3),
            k_s=cat("k_s", -2), v_s=cat("v_s", -2),
        )
    return AttnCache(k=cat("k", -3), v=cat("v", -3))


class KVPager:
    """Block-table KV paging for decode sessions over a tier stack.

    ``store`` is duck-typed: a :class:`~repro_torch.storage.hierarchy.
    TieredStore` engages the full pin/demote/promote machinery; a plain
    :class:`~repro_torch.storage.kvcache.StateCache` (or single tier)
    degrades gracefully — demotion then just rewrites blocks in their
    demoted encoding wherever the store keeps them.  ``device`` is where
    assembled layers are placed: the device the decoder runs on.
    """

    def __init__(
        self,
        store: Any,
        *,
        device: Any,
        block_tokens: int = 16,
        lossless: bool = False,
        dram_budget_bytes: Optional[int] = None,
        prefetch_on_resume: bool = True,
        namespace: str = "kv",
    ) -> None:
        if block_tokens < 1:
            raise ValueError("block_tokens must be >= 1")
        self.store = store
        self.device = torch.device(device)
        self.block_tokens = block_tokens
        self.lossless = lossless
        self.dram_budget_bytes = dram_budget_bytes
        self.prefetch_on_resume = prefetch_on_resume
        self.namespace = namespace.rstrip("/")
        self.stats = PagerStats()
        self._sessions: Dict[str, _Session] = {}
        self._lock = threading.Lock()
        self._clock = itertools.count(1)

    # -- key layout ---------------------------------------------------------
    def session_prefix(self, sid: str) -> str:
        return f"{self.namespace}/{sid}/"

    def _meta_key(self, sid: str) -> str:
        return self.session_prefix(sid) + "meta"

    def _block_key(self, sid: str, layer: int, block: int) -> str:
        return f"{self.session_prefix(sid)}L{layer:03d}/B{block:05d}"

    # -- introspection ------------------------------------------------------
    @property
    def sessions(self) -> List[str]:
        with self._lock:
            return sorted(self._sessions)

    @property
    def resident_sessions(self) -> int:
        with self._lock:
            return sum(1 for s in self._sessions.values() if s.hot)

    @property
    def paged_sessions(self) -> int:
        with self._lock:
            return sum(1 for s in self._sessions.values() if not s.hot)

    def is_hot(self, sid: str) -> bool:
        with self._lock:
            ent = self._sessions.get(sid)
        return bool(ent and ent.hot)

    def dram_bytes(self) -> int:
        """Bytes of block data attributable to hot (DRAM-pinned)
        sessions — the admission accounting, maintained from the blob
        sizes this pager wrote (no tier scan)."""
        with self._lock:
            return sum(s.nbytes for s in self._sessions.values() if s.hot)

    def typical_session_bytes(self) -> int:
        with self._lock:
            sized = [s.nbytes for s in self._sessions.values() if s.sizes]
        return max(sized) if sized else 0

    def can_admit(self, est_bytes: Optional[int] = None) -> bool:
        """Admission knob: would one more hot session fit the DRAM block
        budget?  ``None`` budget admits everything."""
        if self.dram_budget_bytes is None:
            return True
        est = est_bytes if est_bytes is not None else self.typical_session_bytes()
        return self.dram_bytes() + est <= self.dram_budget_bytes

    def lru_hot(self) -> List[str]:
        """Hot sessions, least-recently-touched first (demotion victims
        for admission-driven spills)."""
        with self._lock:
            hot = [(s.last_touch, sid) for sid, s in self._sessions.items()
                   if s.hot]
        return [sid for _, sid in sorted(hot)]

    # -- session registry ---------------------------------------------------
    def _entry(self, sid: str, create: bool = False) -> _Session:
        with self._lock:
            ent = self._sessions.get(sid)
            if ent is None:
                if not create:
                    raise KeyError(f"unknown pager session {sid!r}")
                ent = _Session(sid)
                self._sessions[sid] = ent
            return ent

    def _touch(self, ent: _Session) -> None:
        ent.last_touch = next(self._clock)

    def _note_resident_peak(self) -> None:
        self.stats.max_resident = max(
            self.stats.max_resident, self.resident_sessions
        )

    # -- write path ---------------------------------------------------------
    def create(self, sid: str, layers: Sequence[Any], t: int) -> None:
        """Install a freshly prefilled session: pin its prefix hot and
        write every block (the prefill result)."""
        ent = self._entry(sid, create=True)
        with ent.lock:
            ent.resident = list(layers)
            ent.t = int(t)
            ent.hot = True
            ent.quantized = any(
                isinstance(l, QuantAttnCache) for l in ent.resident
            )
            self._touch(ent)
            pin = getattr(self.store, "pin", None)
            if pin is not None:
                pin(self.session_prefix(sid))
            self._write_blocks(ent, dirty=None)
        self._note_resident_peak()

    def write(self, sid: str, layers: Sequence[Any], t: int) -> None:
        """Per-step write-back: only the block containing the slot the
        decode step at position ``t`` touched (per layer — windowed
        layers wrap at their own ring size)."""
        ent = self._entry(sid)
        with ent.lock:
            ent.resident = list(layers)
            ent.t = int(t)
            self._touch(ent)
            dirty = set()
            for li, layer in enumerate(ent.resident):
                kind = _layer_kind(layer)
                if kind == _OPAQUE:
                    dirty.add((li, 0))
                else:
                    slot = int(t) % _seq_len(layer)
                    dirty.add((li, slot // self.block_tokens))
            self._write_blocks(ent, dirty=dirty)

    def _write_blocks(
        self, ent: _Session, dirty: Optional[set] = None
    ) -> None:
        """Serialize + put the selected (layer, block) blobs and the meta
        record in one batched ``put_many``.  Caller holds ``ent.lock``."""
        assert ent.resident is not None
        items: Dict[str, bytes] = {}
        meta_layers = []
        for li, layer in enumerate(ent.resident):
            kind = _layer_kind(layer)
            if kind == _OPAQUE:
                nb, S = 1, 0
            else:
                S = _seq_len(layer)
                nb = -(-S // self.block_tokens)
            meta_layers.append({"kind": kind, "S": S, "blocks": nb})
            for b in range(nb):
                if dirty is not None and (li, b) not in dirty:
                    continue
                lo = b * self.block_tokens
                hi = min(S, lo + self.block_tokens) if kind != _OPAQUE else 0
                blob = serde.dumps(_slice_block(layer, lo, hi))
                items[self._block_key(ent.sid, li, b)] = blob
                if kind == _QUANT:
                    self.stats.quantized_blocks += 1
        meta = {
            "t": ent.t,
            "quantized": ent.quantized,
            "lossless": self.lossless,
            "layers": meta_layers,
        }
        items[self._meta_key(ent.sid)] = json.dumps(meta).encode()
        self.store.put_many(items)
        for key, blob in items.items():
            ent.sizes[key] = len(blob)
        self.stats.blocks_written += len(items) - 1

    # -- read path ----------------------------------------------------------
    def load(self, sid: str) -> Tuple[List[Any], int]:
        """The decode step's read: the resident handle when hot (no tier
        I/O), otherwise a demand-fault resume + full block assembly
        (reads promote pinned blocks back to the fast level)."""
        try:
            ent = self._entry(sid)
        except KeyError:
            if self.adopt(sid):
                ent = self._entry(sid)
            else:
                raise
        with ent.lock:
            if ent.resident is None:
                if not ent.hot:
                    self.stats.demand_faults += 1
                    self.resume(sid, prefetch=False)
                self._assemble(ent)
            self._touch(ent)
            assert ent.resident is not None
            return list(ent.resident), ent.t

    def _assemble(self, ent: _Session) -> None:
        meta = json.loads(self.store.get(self._meta_key(ent.sid)))
        layers: List[Any] = []
        for li, info in enumerate(meta["layers"]):
            parts = [
                serde.loads(self.store.get(self._block_key(ent.sid, li, b)))
                for b in range(info["blocks"])
            ]
            layers.append(_join_blocks(info["kind"], parts, self.device))
        ent.resident = layers
        ent.t = int(meta["t"])
        ent.quantized = bool(meta["quantized"])

    # -- placement transitions ----------------------------------------------
    def demote(self, sid: str) -> bool:
        """Hot → cold: re-encode blocks int8 (unless ``lossless`` or
        already quantized), unpin, and push every key one level down —
        the warm-pool eviction path (demote, don't drop).  Returns True
        if the session actually moved."""
        try:
            ent = self._entry(sid)
        except KeyError:
            return False
        with ent.lock:
            if not ent.hot:
                return False
            if not self.lossless and not ent.quantized:
                if ent.resident is None:
                    self._assemble(ent)
                assert ent.resident is not None
                ent.resident = [
                    quantize_cache(*l) if isinstance(l, AttnCache) else l
                    for l in ent.resident
                ]
                ent.quantized = any(
                    isinstance(l, QuantAttnCache) for l in ent.resident
                )
                self._write_blocks(ent, dirty=None)
            unpin = getattr(self.store, "unpin", None)
            if unpin is not None:
                unpin(self.session_prefix(sid))
            demoter = getattr(self.store, "demote", None)
            if demoter is not None:
                for key in list(ent.sizes):
                    demoter(key)
            ent.resident = None
            ent.hot = False
            self.stats.demotions += 1
            return True

    def resume(self, sid: str, prefetch: Optional[bool] = None) -> bool:
        """Cold → hot: lazily re-pin the session prefix and (by default)
        enqueue its blocks for background promotion so they are back in
        DRAM before the next decode step; ``prefetch=False`` leaves them
        to demand-fault on first read.  Cheap — no synchronous tier I/O
        either way."""
        prefetch = self.prefetch_on_resume if prefetch is None else prefetch
        try:
            ent = self._entry(sid)
        except KeyError:
            if not self.adopt(sid):
                raise
            ent = self._entry(sid)
        with ent.lock:
            if ent.hot:
                return False
            pin = getattr(self.store, "pin", None)
            if pin is not None:
                try:
                    pin(self.session_prefix(sid), eager=False)
                except TypeError:  # stores without the lazy-pin knob
                    pin(self.session_prefix(sid))
            ent.hot = True
            self._touch(ent)
            self.stats.resumes += 1
            if prefetch:
                promote = getattr(self.store, "promote_async", None)
                if promote is not None:
                    promote(list(self.store.keys(self.session_prefix(sid))))
        self._note_resident_peak()
        return True

    def drop(self, sid: str) -> None:
        """Forget a retired conversation entirely (all tiers)."""
        with self._lock:
            ent = self._sessions.pop(sid, None)
        unpin = getattr(self.store, "unpin", None)
        if unpin is not None:
            unpin(self.session_prefix(sid))
        keys = list(self.store.keys(self.session_prefix(sid)))
        if ent is not None:
            keys = sorted(set(keys) | set(ent.sizes))
        for key in keys:
            self.store.delete(key)

    # -- durability ---------------------------------------------------------
    def sync(self) -> None:
        """Flush the store's write-back queue: every acked block becomes
        crash-durable at the home level (the journal already covers the
        window in journaled configs)."""
        flush = getattr(self.store, "flush", None)
        if flush is not None:
            flush()

    def crash(self) -> None:
        """Simulate losing the serving process: resident handles and the
        session registry vanish; pins are released (a fresh process has
        none).  The store's own crash/recover is the caller's business."""
        with self._lock:
            sids = list(self._sessions)
            self._sessions.clear()
        unpin = getattr(self.store, "unpin", None)
        if unpin is not None:
            for sid in sids:
                unpin(self.session_prefix(sid))

    def adopt(self, sid: str) -> bool:
        """Register one session found in the store (post-restart); cold
        until resumed."""
        if not self.store.contains(self._meta_key(sid)):
            return False
        ent = self._entry(sid, create=True)
        with ent.lock:
            if ent.t < 0:
                meta = json.loads(self.store.get(self._meta_key(sid)))
                ent.t = int(meta["t"])
                ent.quantized = bool(meta["quantized"])
        return True

    def recover(self) -> int:
        """Rediscover every session the store still holds (the prefix
        listing fast path) and register them cold.  Returns the number
        of sessions adopted."""
        suffix = "/meta"
        ns = self.namespace + "/"
        adopted = 0
        for key in self.store.keys(ns):
            if not key.endswith(suffix):
                continue
            sid = key[len(ns):-len(suffix)]
            with self._lock:
                known = sid in self._sessions
            if not known and self.adopt(sid):
                adopted += 1
        return adopted
