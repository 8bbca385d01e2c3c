"""Async multi-tier checkpointing: the paper's §4.3 for a training job.

The port of ``repro/storage/checkpoint.py``.  A checkpoint moves down the
tier stack:

    device (HBM)  --sync copy-->  host staging (DRAM)
                  --background-->  persistent tier (PMEM analog)

``save`` returns once the host copy exists (training goes on), and a
background thread serializes the staged tree and drains it into the
persistent tier with a checksum.  ``restore`` loads the newest *complete*
checkpoint: the manifest is written last, so a crash mid-drain falls back
to the one before.  Blob format, keys and manifest are the reference's,
so either package restores the other's checkpoints; a restored tree
holds host arrays (numpy, or torch for bf16), to be put on whatever
device the resumed job uses.
"""

from __future__ import annotations

import hashlib
import json
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, List, Optional

import torch

from repro_torch.storage import serde
from repro_torch.storage.tiers import Tier
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["CheckpointManager", "CheckpointInfo"]


@dataclass
class CheckpointInfo:
    step: int
    nbytes: int
    checksum: str
    wall_time: float  # seconds to stage the state in host memory
    drain_time: float = 0.0  # seconds to serialize and write it, once durable


def _digest(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=16).hexdigest()


def _to_host(state: Any) -> Any:
    """Every tensor of ``state`` copied to host memory, after one
    synchronize of each card the tensors live on (the copies then read
    finished values); other leaves as they are."""
    for index in sorted({t.get_device() for t in tree_leaves(state)
                         if isinstance(t, torch.Tensor) and t.is_cuda}):
        torch.cuda.synchronize(index)
    return tree_map(
        lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t, state)


class CheckpointManager:
    """Tiered, asynchronous, integrity-checked checkpointing.

    Parameters
    ----------
    tier:
        Persistent tier (PMEM analog) that durable checkpoints land in.
    prefix:
        Key namespace, e.g. ``"ckpt/run42"``.
    keep:
        Number of most-recent complete checkpoints retained.
    """

    def __init__(self, tier: Tier, prefix: str = "ckpt", keep: int = 2) -> None:
        self.tier = tier
        self.prefix = prefix.rstrip("/")
        self.keep = keep
        self._q: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._drain_err: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._drain_loop, daemon=True)
        self._worker.start()

    # -- keys ---------------------------------------------------------------
    def _blob_key(self, step: int) -> str:
        return f"{self.prefix}/step_{step:012d}.blob"

    def _manifest_key(self, step: int) -> str:
        return f"{self.prefix}/step_{step:012d}.manifest"

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, block: bool = False) -> CheckpointInfo:
        """Checkpoint ``state`` (a tree) at ``step``.  The device-to-host
        copy happens here; serialization and the persistent-tier write run
        on the background thread unless ``block=True``."""
        self._check_drain_error()
        t0 = time.perf_counter()
        host_state = _to_host(state)
        nbytes = serde.leaf_bytes(host_state)
        info = CheckpointInfo(step, nbytes, "", time.perf_counter() - t0)
        self._q.put((step, host_state, info))
        if block:
            self.wait()
        return info

    def _drain_one(self, step: int, host_state: Any, info: CheckpointInfo) -> None:
        t0 = time.perf_counter()
        blob = serde.dumps(host_state)
        del host_state
        checksum = _digest(blob)
        self.tier.put(self._blob_key(step), blob)
        manifest = json.dumps(
            {"step": step, "nbytes": len(blob), "checksum": checksum}
        ).encode()
        # the manifest written last is the commit point
        self.tier.put(self._manifest_key(step), manifest)
        info.checksum = checksum
        info.drain_time = time.perf_counter() - t0
        self._gc()

    def _drain_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._drain_one(*item)
            except BaseException as e:  # surfaced on the next save/wait
                self._drain_err = e
            finally:
                del item
                self._q.task_done()

    def wait(self) -> None:
        """Block until every queued checkpoint is durable."""
        self._q.join()
        self._check_drain_error()

    def _check_drain_error(self) -> None:
        if self._drain_err is not None:
            err, self._drain_err = self._drain_err, None
            raise RuntimeError("async checkpoint drain failed") from err

    # -- restore ---------------------------------------------------------------
    def steps(self) -> List[int]:
        """Steps with *complete* (manifest-committed) checkpoints."""
        out = []
        for key in self.tier.keys():
            if key.startswith(self.prefix + "/") and key.endswith(".manifest"):
                stem = key[len(self.prefix) + 1: -len(".manifest")]
                out.append(int(stem.split("_")[1]))
        return sorted(out)

    def restore(self, step: Optional[int] = None) -> Any:
        """Load the checkpoint at ``step`` (default: the newest complete)."""
        self.wait()
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.prefix}")
        if step is None:
            step = steps[-1]
        if step not in steps:
            raise FileNotFoundError(f"no complete checkpoint at step {step}")
        manifest = json.loads(self.tier.get(self._manifest_key(step)))
        blob = self.tier.get(self._blob_key(step))
        if _digest(blob) != manifest["checksum"]:
            raise IOError(f"checkpoint step {step} failed integrity check")
        return serde.loads(blob)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    # -- gc ---------------------------------------------------------------
    def _gc(self) -> None:
        steps = self.steps()
        for old in steps[: -self.keep] if self.keep > 0 else []:
            self.tier.delete(self._manifest_key(old))
            self.tier.delete(self._blob_key(old))

    def close(self) -> None:
        self._q.put(None)
        self._worker.join(timeout=10)
