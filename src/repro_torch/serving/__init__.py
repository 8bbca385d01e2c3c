"""Marvel-Serve: session-granular tiered KV-cache paging for LM decode.

The serving subsystem (DESIGN.md §14): :class:`KVPager` pages decode KV
caches through the tier hierarchy at (session, layer, block) granularity
— hot sessions pinned in DRAM, cold sessions demoted to the PMEM level
as int8-quantized blocks, promotion-on-resume ahead of the next decode
step.  :class:`PagedDecoder` wraps ``decode_step`` as a
``StatefulFunction`` reading/writing through the pager, and
:class:`ServingPool` wires both into the gateway (eviction-routes-to-
demotion, KV-pressure load snapshots, admission shedding).  Prefill runs
the port's flash-attention kernel and every decode step its
decode-attention kernel.
"""

from repro_torch.serving.decode_runtime import (
    PagedDecoder,
    flatten_cache,
    unflatten_cache,
)
from repro_torch.serving.kvpager import KVPager, PagerStats
from repro_torch.serving.sessions import ServingPool

__all__ = [
    "KVPager",
    "PagerStats",
    "PagedDecoder",
    "ServingPool",
    "flatten_cache",
    "unflatten_cache",
]
