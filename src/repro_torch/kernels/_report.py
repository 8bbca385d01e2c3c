"""How the kernel wrappers tell a cost counter of their calls.

A wrapper runs one of three ways: it launches its kernel (a CUDA
tensor), runs its plain version (a CPU tensor), or, for a
``FakeTensor``, only allocates its outputs (:func:`fake`, a dry run's
trace).  Each way reports the call to the innermost active counter
(``launch.cost_analysis.CostCounter``) with the call's arguments, from
which the counter reads the kernel's work
(``launch.roofline.kernel_work``): where a CUDA call adds one to its
launch count, where a fake call would launch, and around a plain
version (:func:`plain`), whose own aten ops the counter then does not
count.  So a step counts the same whichever way its kernels ran.  With
no counter active a report costs one test of an empty list.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, List

import torch
from torch._subclasses.fake_tensor import is_fake

__all__ = ["counters", "fake", "plain", "report"]

#: the active counters, innermost last (``CostCounter`` pushes and pops)
counters: List[Any] = []


def fake(t: torch.Tensor) -> bool:
    """True for a ``FakeTensor``: the wrapper takes its shape path."""
    return type(t) is not torch.Tensor and is_fake(t)


def report(kernel: str, *args: Any, **kw: Any) -> None:
    """One call of ``kernel`` with these arguments, for the innermost
    active counter (none: nothing)."""
    if counters:
        counters[-1].kernel_call(kernel, args, kw)


@contextlib.contextmanager
def plain(kernel: str, *args: Any, **kw: Any) -> Iterator[None]:
    """Around a plain version's run: one call of ``kernel`` for the
    innermost active counter, which counts none of the aten ops inside."""
    if not counters:
        yield
        return
    counter = counters[-1]
    counter.kernel_call(kernel, args, kw)
    with counter.suspended():
        yield
