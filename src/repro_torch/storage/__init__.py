"""Storage substrate: tiers (DRAM/PMEM/simulated SSD/S3), HDFS-analog block
store, Ignite-analog state cache, and the training job's asynchronous
checkpoints into the persistent tier."""

from repro_torch.storage.blockstore import BlockStore, DataNode
from repro_torch.storage.checkpoint import CheckpointInfo, CheckpointManager
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
    "CheckpointInfo",
    "CheckpointManager",
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
