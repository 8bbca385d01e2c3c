"""Device-resident shuffle: the paper's fast tier, on the GPU.

Marvel's speedup comes from moving MapReduce's shuffle out of remote object
storage into a shared in-memory tier.  On the GPU the analogous move is:
keep intermediate key/value data in device memory and exchange it between
owners there, with no host round-trips.  The slow-path baseline
(Corral/S3 analog) ships the same partitions through a host storage tier
(device → tier.put/get → device).

The primitive is MoE-style capacity dispatch: each shard buckets its local
pairs by owner, packs them into a fixed ``(ndev, capacity)`` buffer
(padding key = -1), and the exchange hands each owner all pairs for its
key range.  Overflow beyond capacity either **spills to a host tier**
(over-capacity pairs take the slow path and are merged back host-side —
exact results, the Faasm/Cloudburst fast-over-slow layering) or, without
a spill tier, is dropped and counted.  Keys are int32 ``>= 0``; ownership
is range-partitioned (``key // vocab_local``) so the owner-concatenated
result is already in key order; reductions are segment-sums over the
owner-local slot.  On one GPU (``ndev == 1``, no mesh) the exchange is
the identity.  Across ranks (``mesh=``, a ``DeviceMesh``) each rank packs
its own shard and two ``all_to_all_single`` calls over the mesh axis's
process group carry the buffers to their owners, as the reference's
``shard_map`` does with ``jax.lax.all_to_all``.

Count workloads accumulate in **int32** by default (``value_dtype=None``
infers it from integer value dtypes): an f32 accumulator silently stops
incrementing above 2^24 pairs per bucket.  Weighted reduces keep f32 by
passing float values (or an explicit ``value_dtype``).

This file is also the engine-facing device layer: :class:`DeviceExec` is
the execution context the dataflow/MapReduce engines thread through when
``device=`` mode is on, :func:`device_partition` lowers the partition step
onto the ``bucket_histogram`` CUDA kernel, and
:func:`device_segment_reduce` is the combine/reduce.  Functions that take
``device=`` run on the card (``"cuda"``) unless the caller passes another
device; on the CPU the kernels run their plain versions.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.collectives import all_gather, mesh_axis, pmean
from repro_torch.storage.tiers import Tier

__all__ = [
    "pack_buckets",
    "device_histogram",
    "ShuffleResult",
    "storage_histogram",
    "host_histogram",
    "DeviceExec",
    "device_partition",
    "device_segment_reduce",
]


@dataclass
class ShuffleResult:
    """Owner-sharded reduction result plus shuffle accounting.

    ``shuffled_bytes`` counts the bytes of *actual pairs* moved through
    the shuffle (padding excluded) — comparable across the device and
    storage paths; ``buffer_bytes`` is the full ``ndev² × capacity``
    buffer footprint the exchange reserved.  ``spilled``/``spilled_bytes``
    count over-capacity pairs recovered through the host spill tier
    (``dropped`` is then 0).
    """

    counts: torch.Tensor  # (vocab,) key-ordered histogram
    dropped: torch.Tensor  # scalar: pairs lost to capacity overflow
    shuffled_bytes: int  # actual pair bytes moved through the shuffle
    buffer_bytes: int = 0  # capacity buffer footprint (padding included)
    spilled: int = 0  # overflow pairs recovered via the spill tier
    spilled_bytes: int = 0


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=_np_dtype(dtype))).dtype


def _resolve_value_dtype(values_dtype, value_dtype) -> np.dtype:
    """``None`` infers: integer values accumulate exactly in int32 (count
    workloads), float values keep f32 (weighted reduce)."""
    if value_dtype is not None:
        return _np_dtype(value_dtype)
    integer = np.issubdtype(_np_dtype(values_dtype), np.integer)
    return np.dtype(np.int32 if integer else np.float32)


def _pack_impl(
    keys: torch.Tensor,
    values: torch.Tensor,
    dest: torch.Tensor,
    ndev: int,
    capacity: int,
):
    """Shared packing core → ``(buf_k, buf_v, dropped, ovf_k, ovf_v)``.

    ``ovf_k``/``ovf_v`` carry the over-capacity pairs (dest-sorted order,
    padding key = -1) so a caller with a spill tier can recover them;
    callers without one just read ``dropped``.
    """
    n = keys.shape[0]
    dev = keys.device
    d = torch.where(dest >= 0, dest, ndev)  # invalid -> virtual bucket ndev
    order = torch.argsort(d, stable=True)
    sk = keys[order]
    sv = values[order]
    sd = d[order]
    # First occurrence index of each destination among the sorted dests.
    starts = torch.searchsorted(
        sd, torch.arange(ndev + 1, dtype=sd.dtype, device=dev)
    )
    # dest >= ndev sorts past the virtual bucket: clamp its lookup (the
    # pair is neither kept nor counted as overflow).
    pos = torch.arange(n, device=dev) - starts[sd.clamp(max=ndev).long()]
    valid = sd < ndev
    keep = (pos < capacity) & valid
    buf_k = torch.full((ndev, capacity), -1, dtype=keys.dtype, device=dev)
    buf_v = torch.zeros((ndev, capacity), dtype=values.dtype, device=dev)
    rows, cols = sd[keep].long(), pos[keep]
    buf_k[rows, cols] = sk[keep]
    buf_v[rows, cols] = sv[keep]
    overflow = (~keep) & valid
    ovf_k = torch.where(overflow, sk, -1)
    ovf_v = torch.where(overflow, sv, torch.zeros((), dtype=sv.dtype, device=dev))
    dropped = overflow.sum(dtype=torch.int32)
    return buf_k, buf_v, dropped, ovf_k, ovf_v


def pack_buckets(
    keys: torch.Tensor,  # (n,) int32, >= 0; padding entries = -1
    values: torch.Tensor,  # (n,) numeric
    dest: torch.Tensor,  # (n,) int32 destination in [0, ndev); <0 invalid
    ndev: int,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack local pairs into per-destination send buffers.

    Returns ``(buf_keys (ndev, capacity), buf_vals (ndev, capacity),
    dropped scalar)``.  Overflow beyond ``capacity`` per destination is
    dropped and counted (capacity-factor semantics, as in MoE dispatch);
    empty and all-invalid inputs yield empty buffers with ``dropped == 0``.
    """
    buf_k, buf_v, dropped, _, _ = _pack_impl(keys, values, dest, ndev, capacity)
    return buf_k, buf_v, dropped


def _owner_reduce(
    rk: torch.Tensor,  # (ndev, capacity) received keys
    rv: torch.Tensor,  # (ndev, capacity) received values
    owner_base: int,  # first key this owner holds
    vocab_local: int,
    value_dtype: torch.dtype,
    unit_weights: bool = False,
) -> torch.Tensor:
    slot = rk.reshape(-1).long() - owner_base
    keep = (rk.reshape(-1) >= 0) & (slot >= 0) & (slot < vocab_local)
    if unit_weights:
        # every weight is 1: the reduce counts the kept keys, which is the
        # histogram kernel's work (-1 counts nowhere)
        from repro_torch.kernels import ops

        return ops.shuffle_histogram(torch.where(keep, slot, -1).to(torch.int32),
                                     vocab_local, out_dtype=value_dtype)
    out = torch.zeros((vocab_local,), dtype=value_dtype, device=rk.device)
    out.index_add_(0, slot[keep], rv.reshape(-1)[keep].to(value_dtype))
    return out


def _plan(n_global: int, ndev: int, vocab: int, capacity_factor: float):
    # Ceil, not floor: a floor ``n_local`` would truncate the tail of any
    # input with ``n_global % ndev != 0`` — the storage path pads the last
    # shard with -1 keys instead.
    n_local = -(-n_global // ndev) if n_global else 0
    capacity = max(1, int(math.ceil(capacity_factor * n_local / ndev)))
    vocab_local = int(math.ceil(vocab / ndev))
    return n_local, capacity, vocab_local


def _empty_result(vocab: int, value_dtype, device) -> ShuffleResult:
    return ShuffleResult(
        counts=torch.zeros((vocab,), dtype=_torch_dtype(value_dtype),
                           device=device),
        dropped=torch.zeros((), dtype=torch.int32),
        shuffled_bytes=0,
        buffer_bytes=0,
    )


def _spill_blob(keys: np.ndarray, values: np.ndarray) -> bytes:
    return keys.tobytes() + values.tobytes()


def _unspill_blob(
    blob: bytes, n: int, key_dtype, value_dtype
) -> Tuple[np.ndarray, np.ndarray]:
    kbytes = n * np.dtype(key_dtype).itemsize
    return (
        np.frombuffer(blob[:kbytes], dtype=key_dtype),
        np.frombuffer(blob[kbytes:], dtype=value_dtype),
    )


def host_histogram(
    keys, values, vocab: int, value_dtype=None
) -> np.ndarray:
    """The pure-host reference: same histogram, no device, no tiers.

    Negative keys are padding; integer values accumulate in int32 unless
    ``value_dtype`` overrides.  Benchmarks and the cross-path tests use
    this as the ground truth both shuffle paths must match."""
    k = np.asarray(keys)
    v = np.asarray(values)
    value_dtype = _resolve_value_dtype(v.dtype, value_dtype)
    out = np.zeros((vocab,), dtype=value_dtype)
    valid = k >= 0
    np.add.at(out, k[valid], v[valid].astype(value_dtype))
    return out


def _spill_merge(
    counts: torch.Tensor, ok: np.ndarray, ov: np.ndarray, spill_tier: Tier,
    spill_key: str,
) -> Tuple[torch.Tensor, int]:
    """Over-capacity pairs take the slow path: a real round-trip through
    the host tier (its modeled seconds are the spill cost), then a
    host-side merge back into the reduced counts, in the order given.
    ``ok``/``ov`` hold the overflow with padding key -1.  Returns the
    merged counts (on ``counts``' device) and the bytes spilled."""
    mask = ok >= 0
    blob = _spill_blob(ok[mask], ov[mask])
    spill_tier.put(spill_key, blob)
    rk, rv = _unspill_blob(
        spill_tier.get(spill_key), int(mask.sum()), ok.dtype, ov.dtype,
    )
    merged = counts.cpu().numpy().copy()
    np.add.at(merged, rk, rv.astype(merged.dtype))
    return torch.from_numpy(merged).to(counts.device), len(blob)


def device_histogram(
    keys,  # (n,) int32 tokens, padding = -1: the whole input, or this rank's shard
    values,  # (n,) weights (ones for wordcount)
    ndev: Optional[int] = None,
    vocab: int = 32000,
    capacity_factor: float = 1.3,
    value_dtype=None,
    spill_tier: Optional[Tier] = None,
    spill_key: str = "shuffle/spill/device",
    device=None,
    *,
    mesh=None,
    axis: str = "data",
    unit_weights: bool = False,
) -> ShuffleResult:
    """Map→shuffle→reduce entirely on the device (the Marvel/IGFS fast path).

    This is WordCount/Grep/GroupBy: map emits (key, weight), shuffle
    routes to the key's owner, reduce segment-sums.  ``keys`` and
    ``values`` are tensors or arrays; they are moved to ``device``.

    Without ``mesh`` the call runs on one device (``ndev`` None or 1), and
    ``ndev > 1`` is refused: several owners need a mesh.  With ``mesh``
    (a ``DeviceMesh``) ``ndev`` is the size of its ``axis``; each rank
    passes its own shard (any length; the plan is the reference's over the
    whole input, whose shards are the axis's ranks' in rank order, and the
    ranks along the other axes pass the same shard), and every rank
    returns the whole result.  ``device`` defaults to the mesh's device
    type, else the card.  A mesh of size 1 runs the collectives too.

    With ``spill_tier``, over-capacity pairs round-trip the host tier and
    are merged back into the counts (exact results, ``dropped == 0``) —
    the paper's fast-tier-with-slow-spill layering.

    ``unit_weights=True`` is the caller's word that every weight is 1
    (WordCount; the values are not read to check it): each owner then
    counts its keys with the ``bucket_histogram`` kernel instead of
    segment-summing the values, on one device and on a mesh alike.
    """
    if mesh is not None:
        return _mesh_histogram(keys, values, ndev, vocab, capacity_factor,
                               value_dtype, spill_tier, spill_key, device,
                               mesh, axis, unit_weights)
    if ndev not in (None, 1):
        raise ValueError(
            f"device_histogram over ndev={ndev} owners needs a mesh: pass "
            "mesh= (a DeviceMesh) with ndev ranks along its axis"
        )
    ndev = 1
    dev = _device(device)
    k = torch.as_tensor(keys, device=dev).reshape(-1)
    v = torch.as_tensor(values, device=dev).reshape(-1)
    value_dtype = _resolve_value_dtype(v.dtype, value_dtype)
    if k.shape[0] == 0:
        return _empty_result(vocab, value_dtype, dev)
    _, capacity, vocab_local = _plan(k.shape[0], ndev, vocab, capacity_factor)
    dest = torch.where(k >= 0, k // vocab_local, -1)
    bk, bv, dropped, ovf_k, ovf_v = _pack_impl(k, v, dest, ndev, capacity)
    # One device owns every key: the exchange hands the buffers back as is.
    hist = _owner_reduce(bk, bv, 0, vocab_local, _torch_dtype(value_dtype),
                         unit_weights)
    itemsize = k.element_size() + v.element_size()
    n_valid = int((k >= 0).sum())
    n_dropped = int(dropped)
    counts = hist[:vocab]
    spilled = spilled_bytes = 0
    if spill_tier is not None and n_dropped:
        counts, spilled_bytes = _spill_merge(
            counts, ovf_k.cpu().numpy(), ovf_v.cpu().numpy(), spill_tier,
            spill_key)
        spilled = n_dropped
        n_dropped = 0
    return ShuffleResult(
        counts=counts,
        dropped=torch.tensor(n_dropped, dtype=torch.int32),
        shuffled_bytes=(n_valid - n_dropped - spilled) * itemsize,
        buffer_bytes=ndev * ndev * capacity * itemsize,
        spilled=spilled,
        spilled_bytes=spilled_bytes,
    )


def _mesh_histogram(keys, values, ndev, vocab, capacity_factor, value_dtype,
                    spill_tier, spill_key, device, mesh, axis,
                    unit_weights) -> ShuffleResult:
    """``device_histogram`` across the ranks of ``mesh``'s ``axis``: the
    steps of the reference's ``shard_fn``, with the collectives written
    out over the axis's process group."""
    size, group, me = mesh_axis(mesh, axis)
    if ndev not in (None, size):
        raise ValueError(f"ndev={ndev}, but the mesh's {axis!r} axis has {size} ranks")
    ndev = size
    dev = _device(mesh.device_type if device is None else device)
    k = torch.as_tensor(keys, device=dev).reshape(-1)
    v = torch.as_tensor(values, device=dev).reshape(-1)
    value_dtype = _resolve_value_dtype(v.dtype, value_dtype)
    # every rank's shard length and valid pairs, in rank order: the plan
    # is the whole input's
    mine = torch.stack([torch.tensor(k.shape[0], device=dev), (k >= 0).sum()])
    stats = all_gather(mine.to(torch.int64), group).view(ndev, 2).cpu()
    n_global, n_valid = (int(x) for x in stats.sum(dim=0))
    if n_global == 0:
        return _empty_result(vocab, value_dtype, dev)
    _, capacity, vocab_local = _plan(n_global, ndev, vocab, capacity_factor)
    dest = torch.where(k >= 0, k // vocab_local, -1)
    bk, bv, dropped, ovf_k, ovf_v = _pack_impl(k, v, dest, ndev, capacity)
    rk, rv = torch.empty_like(bk), torch.empty_like(bv)
    dist.all_to_all_single(rk, bk, group=group)
    dist.all_to_all_single(rv, bv, group=group)
    hist = _owner_reduce(rk, rv, me * vocab_local, vocab_local,
                         _torch_dtype(value_dtype), unit_weights)
    total_dropped = dropped.reshape(1).to(torch.int64)
    dist.all_reduce(total_dropped, op=dist.ReduceOp.SUM, group=group)
    for a in mesh.mesh_dim_names:  # replicate over the other axes, as pmean/pmax do
        if a != axis:
            hist = pmean(hist, mesh.get_group(a))
            dist.all_reduce(total_dropped, op=dist.ReduceOp.MAX,
                            group=mesh.get_group(a))
    counts = all_gather(hist, group)[:vocab]
    itemsize = k.element_size() + v.element_size()
    n_dropped = int(total_dropped)
    spilled = spilled_bytes = 0
    if spill_tier is not None and n_dropped:
        # every rank's overflow, padded to the longest shard, in rank
        # order: the reference's P(axis) out-spec
        n_max = int(stats[:, 0].max())
        ok = torch.full((n_max,), -1, dtype=k.dtype, device=dev)
        ov = torch.zeros((n_max,), dtype=v.dtype, device=dev)
        ok[: k.shape[0]], ov[: k.shape[0]] = ovf_k, ovf_v
        counts, spilled_bytes = _spill_merge(
            counts, all_gather(ok, group).cpu().numpy(),
            all_gather(ov, group).cpu().numpy(), spill_tier, spill_key)
        spilled = n_dropped
        n_dropped = 0
    return ShuffleResult(
        counts=counts,
        dropped=torch.tensor(n_dropped, dtype=torch.int32),
        shuffled_bytes=(n_valid - n_dropped - spilled) * itemsize,
        buffer_bytes=ndev * ndev * capacity * itemsize,
        spilled=spilled,
        spilled_bytes=spilled_bytes,
    )


def storage_histogram(
    keys: np.ndarray,
    values: np.ndarray,
    ndev: int,
    tier: Tier,
    vocab: int = 32000,
    capacity_factor: float = 1.3,
    value_dtype=None,
    spill: bool = False,
    device=None,
) -> ShuffleResult:
    """Same computation, but the shuffle round-trips a storage tier.

    This is the Corral/S3 baseline path: each of ``ndev`` shards is packed
    on ``device``, pulled off it, written to ``tier`` (one object per
    (src, dst) pair — the paper's ≥4 I/O calls), read back, and pushed
    onto the device for the reduce.  With a ``SimulatedTier`` the modeled
    seconds reproduce Fig. 4/5's orderings.

    Inputs of any length are exact: the last shard is padded with ``-1``
    keys when ``n_global % ndev != 0``.  ``spill=True`` recovers
    over-capacity pairs through the same tier instead of dropping them.
    """
    dev = _device(device)
    keys = np.asarray(keys)
    values = np.asarray(values)
    n_global = keys.shape[0]
    value_dtype = _resolve_value_dtype(values.dtype, value_dtype)
    if n_global == 0:
        return _empty_result(vocab, value_dtype, dev)
    n_local, capacity, vocab_local = _plan(n_global, ndev, vocab, capacity_factor)

    # Pad to a whole number of shards: -1 keys are ignored everywhere.
    padded_k = np.full((ndev * n_local,), -1, dtype=keys.dtype)
    padded_k[:n_global] = keys
    padded_v = np.zeros((ndev * n_local,), dtype=values.dtype)
    padded_v[:n_global] = values

    dropped = 0
    buffer_bytes = 0
    spill_k: List[np.ndarray] = []
    spill_v: List[np.ndarray] = []
    # Map side: pack per source shard, spill every (src, dst) partition.
    for src in range(ndev):
        shard = slice(src * n_local, (src + 1) * n_local)
        lk = torch.from_numpy(padded_k[shard]).to(dev)
        lv = torch.from_numpy(padded_v[shard]).to(dev)
        dest = torch.where(lk >= 0, lk // vocab_local, -1)
        bk, bv, d, ovf_k, ovf_v = _pack_impl(lk, lv, dest, ndev, capacity)
        dropped += int(d)
        bk_h, bv_h = bk.cpu().numpy(), bv.cpu().numpy()
        if spill and int(d):
            ok, ov = ovf_k.cpu().numpy(), ovf_v.cpu().numpy()
            mask = ok >= 0
            spill_k.append(ok[mask])
            spill_v.append(ov[mask])
        for dst in range(ndev):
            blob = bk_h[dst].tobytes() + bv_h[dst].tobytes()
            tier.put(f"shuffle/{src:04d}/{dst:04d}", blob)
            buffer_bytes += len(blob)
    spilled = spilled_bytes = 0
    if spill_k:
        # Over-capacity pairs ride the same tier as a dedicated spill
        # object — slow-path traffic, not silent loss.
        sk = np.concatenate(spill_k)
        sv = np.concatenate(spill_v)
        blob = _spill_blob(sk, sv)
        tier.put("shuffle/spill", blob)
        spilled = int(sk.shape[0])
        spilled_bytes = len(blob)
    # Reduce side: fetch, reassemble, reduce per owner shard.
    full = np.zeros((vocab_local * ndev,), dtype=value_dtype)
    key_itemsize = keys.dtype.itemsize
    for dst in range(ndev):
        rk = np.empty((ndev, capacity), dtype=keys.dtype)
        rv = np.empty((ndev, capacity), dtype=values.dtype)
        for src in range(ndev):
            blob = tier.get(f"shuffle/{src:04d}/{dst:04d}")
            kbytes = capacity * key_itemsize
            rk[src] = np.frombuffer(blob[:kbytes], dtype=keys.dtype)
            rv[src] = np.frombuffer(blob[kbytes:], dtype=values.dtype)
        hist = _owner_reduce(
            torch.from_numpy(rk).to(dev), torch.from_numpy(rv).to(dev),
            dst * vocab_local, vocab_local, _torch_dtype(value_dtype),
        )
        full[dst * vocab_local : (dst + 1) * vocab_local] = hist.cpu().numpy()
    if spilled:
        rk, rv = _unspill_blob(
            tier.get("shuffle/spill"), spilled, keys.dtype, values.dtype
        )
        np.add.at(full, rk, rv.astype(full.dtype))
        dropped = 0
    n_valid = int((keys >= 0).sum())
    itemsize = key_itemsize + values.dtype.itemsize
    return ShuffleResult(
        counts=torch.from_numpy(full[:vocab].copy()).to(dev),
        dropped=torch.tensor(dropped, dtype=torch.int32),
        shuffled_bytes=(n_valid - dropped - spilled) * itemsize,
        buffer_bytes=buffer_bytes,
        spilled=spilled,
        spilled_bytes=spilled_bytes,
    )


# -- engine-facing device execution -------------------------------------------

@dataclass
class DeviceExec:
    """The device-execution context the engines thread through.

    One instance per job run (the façade builds a fresh one per
    submission); counters are cumulative across that run's tasks and are
    incremented from scheduler worker threads, hence the lock.
    ``device`` is where the partition kernel and the segment-sum run (the
    CPU runs their plain versions); ``capacity_factor`` sizes the
    partition send buffers — overflow beyond it spills through the
    intermediate tier instead of being dropped.
    """

    device: torch.device = field(
        default_factory=lambda: torch.device("cuda")
    )
    capacity_factor: float = 1.3
    partitioned_pairs: int = 0
    reduced_groups: int = 0
    spilled_pairs: int = 0
    fallback_tasks: int = 0
    device_tasks: int = 0
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def account(self, **deltas: int) -> None:
        with self._lock:
            for name, delta in deltas.items():
                setattr(self, name, getattr(self, name) + int(delta))


def device_partition(
    dest,
    n_parts: int,
    capacity: Optional[int] = None,
    device=None,
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Lower the engine's partition step onto the histogram kernel.

    ``dest[i]`` is pair *i*'s destination partition (negative = drop the
    pair).  Returns ``(parts, overflow)``: per-partition int64 index
    arrays in original pair order (the packing argsort is stable), and
    the indices of over-capacity pairs (for the caller to spill).
    ``capacity=None`` sizes buffers from the kernel's counts — no
    overflow possible.
    """
    from repro_torch.kernels import ops

    dest = np.asarray(dest, dtype=np.int32)
    n = dest.shape[0]
    if n == 0:
        empty = np.empty((0,), dtype=np.int64)
        return [empty.copy() for _ in range(n_parts)], empty
    dev = _device(device)
    d = torch.from_numpy(dest).to(dev)
    # The partition step of the hot phase: per-partition counts from the
    # histogram kernel size the capacity buffers.
    counts = ops.partition_counts(d, n_parts).cpu().numpy()
    cap = int(counts.max()) if capacity is None else int(capacity)
    cap = max(1, cap)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    buf_idx, _, _, ovf_idx, _ = _pack_impl(idx, idx, d, n_parts, cap)
    buf = buf_idx.cpu().numpy()
    parts = [row[row >= 0].astype(np.int64) for row in buf]
    ovf = ovf_idx.cpu().numpy()
    return parts, ovf[ovf >= 0].astype(np.int64)


def _segment_sum(
    ids: torch.Tensor, values: torch.Tensor, n_segments: int
) -> torch.Tensor:
    keep = (ids >= 0) & (ids < n_segments)
    out = torch.zeros((n_segments,), dtype=values.dtype, device=values.device)
    return out.index_add_(0, ids[keep].long(), values[keep])


def device_segment_reduce(
    ids,
    values,
    n_segments: int,
    value_dtype=None,
    device=None,
) -> np.ndarray:
    """The combine/reduce: segment-sum ``values`` by ``ids`` on ``device``.

    Integer values accumulate in int32 (exact up to 2^31; the engine only
    lowers reduces whose total provably fits).
    """
    values = np.asarray(values)
    value_dtype = _resolve_value_dtype(values.dtype, value_dtype)
    if n_segments < 1:
        return np.zeros((0,), dtype=value_dtype)
    dev = _device(device)
    out = _segment_sum(
        torch.from_numpy(np.asarray(ids, dtype=np.int32)).to(dev),
        torch.from_numpy(values.astype(value_dtype)).to(dev),
        n_segments,
    )
    return out.cpu().numpy()
