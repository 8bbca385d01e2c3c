"""Shuffle-partition histogram: a CUDA kernel for Hopper.

The MapReduce shuffle planner (core/device_shuffle.py) needs per-bucket
counts of a key block to size its capacity buffers: the partition step of
the paper's hot phase.  This replaces the Pallas TPU kernel
``repro/kernels/bucket_histogram.py::bucket_histogram``.  The TPU kernel
sums a one-hot panel on the MXU for want of a scatter-add; the CUDA kernel
(``csrc/bucket_histogram.cu``) counts by one of three routes, chosen by
``n_buckets`` (:func:`_plan`):

- ``regs`` (≤ 16 buckets, the engine's reducers and TeraSort's ranges):
  counts in each thread's registers, summed per warp, no atomics per key;
- ``smem`` (≤ 58,112, what one block's shared memory holds): replicated
  sub-histograms in shared memory, one per warp where they fit;
- ``global`` (above): a global atomic per key.

What bounds it: it reads the keys once, 4·N bytes (plus 4·n_buckets
written), with one compare and one add per key, so the memory rate is
the bound; at the main path's shapes (about 10^5 keys) the launch and the
wrapper's host time are.  So up to :data:`CROSSOVER` keys a call is one
cluster of at most 16 blocks that folds its counts through distributed
shared memory and stores the output itself: one device operation into an
uninitialised output.  Above it a grid of clusters fills the card and adds
into an output it zeroes first (two operations); the ``global`` route
always does.  The plan is pure Python, prepared once per (device,
``n_buckets``, size class of N); the device's SM count and shared-memory
opt-in are read, and the kernels' attributes set, once per device; a call
queries nothing.

Contract (the reference's): negative keys are padding, keys ≥
``n_buckets`` are dropped, ``N == 0`` gives zeros, counts are exact int32.
:func:`bucket_histogram` launches the kernel for a CUDA tensor and takes
the plain version, :func:`bucket_histogram_torch`, only for a CPU tensor.
``launches`` counts the kernel's launches (one per CUDA call).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build, _report
from repro_torch.kernels._build import _raw_stream, forward_only

__all__ = ["bucket_histogram", "bucket_histogram_torch", "launches"]

#: kernel launches so far (the plain CPU version does not count).
launches = 0
THREADS = 1024  #: threads per block (``kThreads`` in the source)
MAX_CLUSTER = 16  #: the largest (non-portable) cluster
REGS_WIDTHS = (4, 8, 16)  #: bucket counts the register route is built for
#: one cluster's blocks get a block per this many keys (two 16-byte loads
#: per thread), up to MAX_CLUSTER blocks
KEYS_PER_BLOCK = 8 * THREADS
#: up to this many keys a call is one cluster; above it, a grid of clusters.
#: Measured for the regs route, the main path's, on an H100
#: (chip_hist_crossover.py).  The smem route, which no caller takes, shares
#: it, although its own crossover lies lower (about 2^17.5 keys).
CROSSOVER = 1 << 18
GRID_CLUSTER = 2  #: blocks per cluster in a grid: pairs fold before the atomics
ROUTES = ("regs", "smem", "global")
_count_lock = threading.Lock()
_entry = None


class Plan(NamedTuple):
    """How one call runs: the route, one cluster (``single``: one device
    operation) or a grid of clusters (a memset and a launch), and the
    kernel's launch shape."""

    route: str
    width: int  # regs: the template's bucket count
    single: bool
    grid: int  # blocks, a multiple of cluster
    cluster: int
    smem: int  # dynamic shared bytes per block
    copies: int  # smem: sub-histograms per block


def _plan(n: int, n_buckets: int, sms: int, smem_optin: int) -> Plan:
    """The plan for ``n`` keys into ``n_buckets`` on a card of ``sms`` SMs
    whose blocks may opt into ``smem_optin`` bytes of shared memory."""
    words = smem_optin // 4
    single = n <= CROSSOVER
    one = min(MAX_CLUSTER, max(1, -(-n // KEYS_PER_BLOCK)))
    width, copies = 0, 1
    if n_buckets <= REGS_WIDTHS[-1]:
        route = "regs"
        width = next(w for w in REGS_WIDTHS if w >= n_buckets)
        smem = 4 * width
        cluster = one if single else GRID_CLUSTER
    elif n_buckets <= words:
        route = "smem"
        copies = max(1, min(THREADS // 32, words // n_buckets))
        smem = 4 * copies * n_buckets
        cluster = one if single else GRID_CLUSTER
    else:
        route, single, cluster, smem = "global", False, 1, 0
    grid = cluster if single else max(1, sms // cluster) * cluster
    return Plan(route, width, single, grid, cluster, smem, copies)


class _Plan(ctypes.Structure):
    """``Plan`` in ``csrc/bucket_histogram.cu``, field for field."""

    _fields_ = [(f, ctypes.c_int32) for f in (
        "route", "width", "single", "grid", "cluster", "smem", "copies")]


def _struct(plan: Plan) -> _Plan:
    return _Plan(ROUTES.index(plan.route), plan.width, int(plan.single),
                 plan.grid, plan.cluster, plan.smem, plan.copies)


class _Entry(NamedTuple):
    launch: object
    configure: object
    error: object


def _launcher() -> _Entry:
    global _entry
    if _entry is None:
        lib = _build.load("bucket_histogram")
        launch = lib.bucket_histogram_launch
        launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        launch.restype = ctypes.c_int
        configure = lib.bucket_histogram_configure
        configure.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        configure.restype = ctypes.c_int
        err = lib.bucket_histogram_error
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _entry = _Entry(launch, configure, err)
    return _entry


def _check_err(err: int, what: str) -> None:
    if err:
        raise RuntimeError(
            f"bucket_histogram {what} failed: {_launcher().error(err).decode()}"
        )


def _configure(index: int) -> Tuple[int, int]:
    """Read device ``index``'s SM count and shared-memory opt-in and set
    the kernels' attributes there."""
    sms, optin = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        err = _launcher().configure(ctypes.byref(sms), ctypes.byref(optin))
    _check_err(err, "configure")
    return sms.value, optin.value


#: (SM count, shared-memory opt-in) by device index, read once per device
_devices: Dict[int, Tuple[int, int]] = {}


class _Call(NamedTuple):
    plan: Plan
    struct: _Plan  # kept alive: the launcher reads it through `address`
    address: int


#: prepared calls by (device, n_buckets, size class of N); cleared when full
_calls: Dict[tuple, _Call] = {}
_CALLS_MAX = 256


def _size_class(n: int) -> int:
    """What of N the plan depends on: 0 above the crossover, else the
    blocks of the one cluster."""
    return 0 if n > CROSSOVER else min(MAX_CLUSTER, max(1, -(-n // KEYS_PER_BLOCK)))


def _call_for(index: int, n: int, n_buckets: int) -> _Call:
    """The prepared call for ``n`` keys into ``n_buckets`` on device
    ``index``, planned on the first call of its signature."""
    key = (index, n_buckets, _size_class(n))
    call = _calls.get(key)
    if call is None:
        info = _devices.get(index)
        if info is None:
            info = _devices[index] = _configure(index)
        plan = _plan(n, n_buckets, *info)
        struct = _struct(plan)
        call = _Call(plan, struct, ctypes.addressof(struct))
        if len(_calls) >= _CALLS_MAX:
            _calls.clear()
        _calls[key] = call
    return call


def bucket_histogram_torch(
    keys: torch.Tensor, n_buckets: int, out_dtype: torch.dtype = torch.int32
) -> torch.Tensor:
    """The plain version: a masked scatter-add in int64, then a cast."""
    valid = (keys >= 0) & (keys < n_buckets)
    idx = keys[valid].long()
    counts = torch.zeros(n_buckets, dtype=torch.int64, device=keys.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx))
    return counts.to(out_dtype)


def bucket_histogram(
    keys: torch.Tensor,  # (N,) int32; negative = padding
    n_buckets: int,
    *,
    out_dtype: torch.dtype = torch.int32,
) -> torch.Tensor:
    """Counts per bucket, ``(n_buckets,)`` in ``out_dtype``.  A
    ``FakeTensor`` of keys (a dry run's trace) gets an output of that
    shape, type and device and no launch."""
    global launches
    if keys.requires_grad:  # never for int32 keys: a float input raises here
        forward_only("bucket_histogram", keys)
    if n_buckets < 1:
        raise ValueError(f"n_buckets must be >= 1, got {n_buckets}")
    if keys.dtype != torch.int32:
        raise TypeError(f"keys must be int32, got {keys.dtype}")
    if keys.dim() != 1:
        raise ValueError(f"keys must be 1-D, got shape {tuple(keys.shape)}")
    n = keys.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"N = {n} keys would overflow the int32 counts")
    if _report.fake(keys):
        _report.report("bucket_histogram", keys, n_buckets)
        return keys.new_empty(n_buckets).to(out_dtype)
    if not keys.is_cuda:
        if keys.device.type != "cpu":
            raise ValueError(f"keys on unsupported device {keys.device}")
        with _report.plain("bucket_histogram", keys, n_buckets):
            return bucket_histogram_torch(keys, n_buckets, out_dtype)
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    index = keys.get_device()
    call = _call_for(index, n, n_buckets)
    out = keys.new_empty(n_buckets)  # int32: the launch sets every count
    launch = (_entry or _launcher()).launch
    if index == torch.cuda.current_device():
        err = launch(call.address, keys.data_ptr(), n, n_buckets,
                     out.data_ptr(), _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = launch(call.address, keys.data_ptr(), n, n_buckets,
                         out.data_ptr(), _raw_stream(index))
    if err:
        _check_err(err, "launch")
    with _count_lock:
        launches += 1
    if _report.counters:
        _report.report("bucket_histogram", keys, n_buckets)
    return out if out_dtype == torch.int32 else out.to(out_dtype)
