"""HDFS analog: a block store with locality metadata.

In Marvel, HDFS DataNodes (PMEM-backed) hold input/output blocks and the
NameNode serves block→node locality so YARN can schedule mappers next to
their data (compute/data co-location, paper §3.4.2).

Here a :class:`BlockStore` owns a set of :class:`DataNode` s (each a tier),
splits files into fixed-size blocks, replicates them, and exposes the
NameNode-style metadata the scheduler uses for locality-aware placement.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.storage.tiers import Tier

__all__ = ["BlockMeta", "FileMeta", "DataNode", "BlockStore"]

DEFAULT_BLOCK_SIZE = 64 * 2**20  # HDFS-ish 64 MiB default (configurable)


@dataclass
class BlockMeta:
    block_id: str
    length: int
    #: node ids holding a replica, primary first (NameNode locality map).
    replicas: List[str]
    checksum: str


@dataclass
class FileMeta:
    path: str
    length: int
    block_size: int
    blocks: List[BlockMeta] = field(default_factory=list)


@dataclass
class DataNode:
    node_id: str
    tier: Tier

    def block_key(self, block_id: str) -> str:
        return f"blocks/{block_id}"


def _checksum(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=16).hexdigest()


class BlockStore:
    """NameNode + DataNodes in one object (metadata is process-local).

    The metadata operations mirror what the MapReduce scheduler needs:
    ``locate`` for locality-aware mapper placement, ``write``/``read`` for
    job input/output, and ``fail_node``/``decommission`` for the
    fault-tolerance tests (re-replication from surviving replicas).
    """

    def __init__(
        self,
        nodes: Sequence[DataNode],
        block_size: int = DEFAULT_BLOCK_SIZE,
        replication: int = 1,
        seed: int = 0,
    ) -> None:
        if not nodes:
            raise ValueError("BlockStore needs at least one DataNode")
        self.nodes: Dict[str, DataNode] = {n.node_id: n for n in nodes}
        self.block_size = block_size
        self.replication = min(replication, len(nodes))
        self._files: Dict[str, FileMeta] = {}
        self._rng = random.Random(seed)
        self._dead: set = set()

    # -- NameNode metadata --------------------------------------------------
    def exists(self, path: str) -> bool:
        return path in self._files

    def file_meta(self, path: str) -> FileMeta:
        return self._files[path]

    def locate(self, path: str) -> List[BlockMeta]:
        """Block→replica-nodes map (what mappers ask the NameNode for)."""
        return list(self._files[path].blocks)

    def live_nodes(self) -> List[str]:
        return [nid for nid in self.nodes if nid not in self._dead]

    def add_node(self, node: DataNode) -> None:
        """Register a new DataNode (cluster elasticity: ``add_node`` on the
        router grows the store too).  Existing blocks stay where they are;
        the new node becomes a candidate for future writes and
        re-replication."""
        self.nodes[node.node_id] = node
        self._dead.discard(node.node_id)

    # -- write/read ----------------------------------------------------------
    def _pick_replicas(self, k: int) -> List[str]:
        live = self.live_nodes()
        if len(live) < k:
            raise RuntimeError(f"not enough live DataNodes ({len(live)} < {k})")
        return self._rng.sample(live, k)

    def _split(self, data: bytes, record_delim: Optional[bytes]) -> List[bytes]:
        """Split into ~block_size chunks; if ``record_delim`` is given, cut
        only on delimiter boundaries so records never straddle blocks (the
        HDFS input-split contract MapReduce relies on)."""
        if not data:
            return [b""]
        chunks = []
        i = 0
        n = len(data)
        while i < n:
            j = min(i + self.block_size, n)
            if record_delim and j < n:
                cut = data.rfind(record_delim, i, j)
                if cut > i:
                    j = cut + len(record_delim)
            chunks.append(data[i:j])
            i = j
        return chunks

    def write(
        self, path: str, data: bytes, record_delim: Optional[bytes] = None
    ) -> FileMeta:
        meta = FileMeta(path=path, length=len(data), block_size=self.block_size)
        for i, chunk in enumerate(self._split(data, record_delim)):
            block_id = f"{_checksum(path.encode())[:8]}_{i:06d}"
            replicas = self._pick_replicas(self.replication)
            for nid in replicas:
                node = self.nodes[nid]
                node.tier.put(node.block_key(block_id), chunk)
            meta.blocks.append(
                BlockMeta(block_id, len(chunk), replicas, _checksum(chunk))
            )
        self._files[path] = meta
        return meta

    def read_block(self, block: BlockMeta, prefer_node: Optional[str] = None) -> bytes:
        """Read one block, preferring a local replica (data co-location)."""
        order = list(block.replicas)
        if prefer_node and prefer_node in order:
            order.remove(prefer_node)
            order.insert(0, prefer_node)
        last_err: Optional[Exception] = None
        for nid in order:
            if nid in self._dead:
                continue
            node = self.nodes[nid]
            try:
                data = node.tier.get(node.block_key(block.block_id))
            except Exception as e:  # replica lost
                last_err = e
                continue
            if _checksum(data) != block.checksum:
                last_err = IOError(f"checksum mismatch on {nid}:{block.block_id}")
                continue
            return data
        raise IOError(f"no live replica for block {block.block_id}") from last_err

    def read(self, path: str) -> bytes:
        return b"".join(self.read_block(b) for b in self._files[path].blocks)

    def delete(self, path: str) -> None:
        meta = self._files.pop(path, None)
        if meta is None:
            return
        for block in meta.blocks:
            for nid in block.replicas:
                node = self.nodes.get(nid)
                if node is not None:
                    node.tier.delete(node.block_key(block.block_id))

    # -- failure handling ------------------------------------------------------
    def fail_node(self, node_id: str) -> None:
        """Mark a DataNode dead (drops its replicas from service)."""
        self._dead.add(node_id)

    def recover_node(self, node_id: str) -> None:
        self._dead.discard(node_id)

    def re_replicate(
        self,
        on_copy: Optional[Callable[[str, str, int], None]] = None,
    ) -> int:
        """Restore replication factor after failures; returns blocks fixed.

        ``on_copy(src_node, dst_node, nbytes)`` is invoked before each
        replica copy — the cluster router charges the modeled network
        fabric here.  If the hook raises (e.g. the link is partitioned),
        that candidate is skipped and the block stays under-replicated
        until a later ``re_replicate`` after the link heals."""
        fixed = 0
        for meta in self._files.values():
            for block in meta.blocks:
                live = [r for r in block.replicas if r not in self._dead]
                if not live:
                    raise IOError(f"block {block.block_id} lost all replicas")
                need = self.replication - len(live)
                if need <= 0:
                    block.replicas = live
                    continue
                data = self.read_block(block)
                candidates = [n for n in self.live_nodes() if n not in live]
                for nid in candidates:
                    if need <= 0:
                        break
                    if on_copy is not None:
                        try:
                            on_copy(live[0], nid, len(data))
                        except Exception:
                            continue  # unreachable candidate; try the next
                    node = self.nodes[nid]
                    node.tier.put(node.block_key(block.block_id), data)
                    live.append(nid)
                    fixed += 1
                    need -= 1
                block.replicas = live
        return fixed

    def under_replicated(self) -> List[str]:
        """Block ids currently below the replication factor (live replicas
        only) — what the partition-tolerance tests assert on."""
        out = []
        for meta in self._files.values():
            for block in meta.blocks:
                live = [r for r in block.replicas if r not in self._dead]
                if len(live) < self.replication:
                    out.append(block.block_id)
        return out
