"""Core: the paper's contribution — stateful serverless execution with a
tiered state store, and the MapReduce engine whose shuffle rides the fast
tier (device memory) instead of remote storage."""

from repro_torch.core.device_shuffle import (
    DeviceExec,
    ShuffleResult,
    device_histogram,
    device_partition,
    device_segment_reduce,
    host_histogram,
    pack_buckets,
    storage_histogram,
)
from repro_torch.core.dag import StageDag, TaskContext, TaskSpec, task_token
from repro_torch.core.dataflow import (
    LoopContext,
    LoopReport,
    Stage,
    StageRunReport,
    StageTask,
    lower_stages,
    run_loop,
    run_stages,
)
from repro_torch.core.gateway import (
    AdmissionError,
    Gateway,
    GatewayClosedError,
    GatewayStats,
    InvokerStats,
)
from repro_torch.core.journal import StateJournal
from repro_torch.core.mapreduce import (
    JobReport,
    LoweredJob,
    MapReduceJob,
    lower_job,
    run_job,
    run_jobs,
)
from repro_torch.core.scheduler import Scheduler, Task, TaskFailedError
from repro_torch.core.stateful import FunctionRuntime, Session, StatefulFunction

__all__ = [
    "AdmissionError",
    "Gateway",
    "GatewayClosedError",
    "GatewayStats",
    "InvokerStats",
    "DeviceExec",
    "ShuffleResult",
    "device_histogram",
    "device_partition",
    "device_segment_reduce",
    "host_histogram",
    "pack_buckets",
    "storage_histogram",
    "JobReport",
    "LoopContext",
    "LoopReport",
    "LoweredJob",
    "MapReduceJob",
    "Stage",
    "StageRunReport",
    "StageTask",
    "lower_stages",
    "run_loop",
    "run_stages",
    "lower_job",
    "run_job",
    "run_jobs",
    "Scheduler",
    "StageDag",
    "StateJournal",
    "Task",
    "TaskContext",
    "TaskSpec",
    "task_token",
    "TaskFailedError",
    "FunctionRuntime",
    "Session",
    "StatefulFunction",
]
