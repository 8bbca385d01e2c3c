"""What one rank's step costs, counted as it runs: the counterpart of
``repro/launch/hlo_analysis.py``.

The reference parses the partitioned HLO of a compiled step.  Here the
step runs once, eagerly, under :class:`CostCounter`, a
``TorchDispatchMode`` that sees every aten op the rank runs — on fake
tensors in a dry run (``launch/dryrun.py``), so no memory is allocated
and no kernel launched, or on real ones — and counts:

  * dot FLOPs: each matmul-like aten op (``mm``, ``bmm``, ``addmm``,
    ``baddbmm``, convolutions, …) by ``torch.utils.flop_counter``'s
    registry, the forward's and the backward's alike;
  * collective bytes by the reference's five kinds (all-gather /
    all-reduce / reduce-scatter / all-to-all / collective-permute): each
    c10d op's result bytes, as ``hlo_analysis.py`` counts them, and the
    same bytes by where the op's group lies (``roofline.link_of``);
  * the hand kernels' calls, FLOPs and bytes by name, as each wrapper
    reports a call (``kernels/_report.py``), from
    ``roofline.kernel_work``.  While a kernel's plain version runs (a CPU
    tensor) its own aten ops are not counted, so a step counts the same
    on fake tensors, on the CPU and on the card;
  * the high-water mark of live storage bytes made while it counts.

What has no counterpart: the reference's while-loop weighting
(``n_while``, the ``*_unweighted`` counts).  Eager code runs every
iteration of every loop, so each count here is exact by construction.
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Dict, Iterator, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _report
from repro_torch.launch.roofline import kernel_work, link_of

__all__ = ["COLLECTIVE_KINDS", "CostCounter", "ModuleCosts"]

COLLECTIVE_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

#: c10d op -> the reference's collective kind; its first argument holds
#: the result's tensors
_C10D_KINDS = {
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}


@dataclass
class ModuleCosts:
    """One rank's counts of one step."""

    dot_flops: float = 0.0
    collective_bytes: Dict[str, int] = field(
        default_factory=lambda: {k: 0 for k in COLLECTIVE_KINDS})
    #: the same bytes by where each op's group lies: "nvlink" or "net"
    link_bytes: Dict[str, int] = field(
        default_factory=lambda: {"nvlink": 0, "net": 0})
    kernel_calls: Dict[str, int] = field(default_factory=dict)
    kernel_flops: Dict[str, float] = field(default_factory=dict)
    kernel_bytes: Dict[str, float] = field(default_factory=dict)
    #: each call's FLOPs over the peak of its type, summed (seconds)
    kernel_compute_s: Dict[str, float] = field(default_factory=dict)
    #: high-water mark of live storage bytes made while counting
    peak_bytes: int = 0
    #: storage bytes made while counting and still live when it ended
    live_bytes: int = 0

    @property
    def total_collective_bytes(self) -> int:
        return sum(self.collective_bytes.values())


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts the costs of what runs inside it (module docstring) into
    :attr:`costs`.  Enter it inside a ``FakeTensorMode`` to trace on fake
    tensors.  Counters nest: a kernel call reports to the innermost."""

    def __init__(self) -> None:
        super().__init__()
        self.costs = ModuleCosts()
        self._plain = 0  # depth of plain versions running
        self._live: Dict[int, Tuple[weakref.ref, int]] = {}
        self._live_bytes = 0

    def __enter__(self):
        _report.counters.append(self)
        try:
            return super().__enter__()
        except BaseException:
            _report.counters.remove(self)
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _report.counters.remove(self)
            self.costs.live_bytes = self._live_bytes

    @contextlib.contextmanager
    def suspended(self) -> Iterator[None]:
        """Count no aten op inside (a kernel's plain version)."""
        self._plain += 1
        try:
            yield
        finally:
            self._plain -= 1

    def kernel_call(self, name: str, args: tuple, kw: dict) -> None:
        """One call of hand kernel ``name`` (``kernels/_report.py``)."""
        work = kernel_work(name, *args, **kw)
        c = self.costs
        c.kernel_calls[name] = c.kernel_calls.get(name, 0) + 1
        c.kernel_flops[name] = c.kernel_flops.get(name, 0) + work.flops
        c.kernel_bytes[name] = c.kernel_bytes.get(name, 0) + work.bytes
        c.kernel_compute_s[name] = (c.kernel_compute_s.get(name, 0.0)
                                    + work.ops_ms / 1e3)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if not self._plain and packet in flop_registry:
            self.costs.dot_flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.namespace == "c10d":
            self._collective(func, args, kwargs)
        # a view or an in-place op's result is its input's storage: not made
        inputs = {id(t.untyped_storage()) for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t, inputs)
        return out

    def _collective(self, func, args, kwargs) -> None:
        kind = _C10D_KINDS.get(func._schema.name.split("::")[-1])
        if kind is None:
            return
        nbytes = sum(_tensor_bytes(t) for t in tree_leaves(args[0])
                     if isinstance(t, torch.Tensor))
        self.costs.collective_bytes[kind] += nbytes
        for i, a in enumerate(func._schema.arguments):
            if a.name == "process_group":
                box = args[i] if i < len(args) else kwargs[a.name]
                ranks = dist.get_process_group_ranks(dist.ProcessGroup.unbox(box))
                self.costs.link_bytes[link_of(ranks)] += nbytes
                return

    def _track(self, t: torch.Tensor, inputs: set) -> None:
        """Count ``t``'s storage the first time it is seen as made, until
        it dies."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._live or key in inputs:
            return
        nbytes = st.nbytes()

        def died(_ref, key=key, nbytes=nbytes):
            if self._live.pop(key, None) is not None:
                self._live_bytes -= nbytes

        self._live[key] = (weakref.ref(st, died), nbytes)
        self._live_bytes += nbytes
        if self._live_bytes > self.costs.peak_bytes:
            self.costs.peak_bytes = self._live_bytes
