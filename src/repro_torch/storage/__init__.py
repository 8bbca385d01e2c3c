"""Storage substrate: tiers (DRAM/PMEM/simulated SSD/S3), HDFS-analog block
store and Ignite-analog state cache.  (Checkpointing waits for the
training slice of the port.)"""

from repro_torch.storage.blockstore import BlockStore, DataNode
from repro_torch.storage.faults import FaultInjectingTier, InjectedIOError, TornWriteError
from repro_torch.storage.hierarchy import PlacementPolicy, TieredStore, TierLevel
from repro_torch.storage.kvcache import StateCache
from repro_torch.storage.tiers import (
    PMEM_SPEC,
    S3_SPEC,
    SSD_SPEC,
    DeviceSpec,
    DramTier,
    PmemTier,
    QuotaExceededError,
    SimulatedTier,
    Tier,
    TierStats,
    tier_accounting,
)

__all__ = [
    "BlockStore",
    "DataNode",
    "FaultInjectingTier",
    "InjectedIOError",
    "TornWriteError",
    "StateCache",
    "PlacementPolicy",
    "TierLevel",
    "TieredStore",
    "DeviceSpec",
    "DramTier",
    "PmemTier",
    "QuotaExceededError",
    "SimulatedTier",
    "Tier",
    "TierStats",
    "tier_accounting",
    "PMEM_SPEC",
    "SSD_SPEC",
    "S3_SPEC",
]
