"""Deterministic synthetic data pipeline with sharded, prefetched batches:
the port's own copy of ``repro/data/pipeline.py``, numpy only, so a batch
is byte for byte the reference's for the same (config, step).

The stream has learnable structure (an affine next-token rule applied with
probability ``p_rule``, Zipf-distributed resets otherwise), so the training
examples show real loss descent without external datasets.  Batches are
deterministic in (seed, step) — a restarted job resumes mid-epoch at the
exact batch, which the checkpoint/restart test relies on (the paper's
stateful-recovery semantics applied to the input pipeline).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

__all__ = ["PipelineConfig", "SyntheticTokens", "make_batch"]


@dataclass(frozen=True)
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    p_rule: float = 0.9
    #: this process's shard (multi-host data parallelism)
    process_index: int = 0
    process_count: int = 1


def make_batch(cfg: PipelineConfig, step: int) -> Dict[str, np.ndarray]:
    """Batch for ``step`` — pure function of (cfg, step)."""
    assert cfg.global_batch % cfg.process_count == 0
    local_b = cfg.global_batch // cfg.process_count
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.process_index])
    )
    B, T, V = local_b, cfg.seq_len, cfg.vocab
    a = 31337 % V or 7
    c = 17
    toks = np.empty((B, T + 1), np.int64)
    toks[:, 0] = rng.integers(0, V, B)
    # Zipf-ish resets: sample from a small head of the vocab.
    head = max(2, V // 64)
    resets = rng.random((B, T)) > cfg.p_rule
    reset_vals = rng.integers(0, head, (B, T))
    for t in range(T):
        nxt = (toks[:, t] * a + c) % V
        toks[:, t + 1] = np.where(resets[:, t], reset_vals[:, t], nxt)
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }


class SyntheticTokens:
    """Prefetching iterator over ``make_batch``.

    A background thread keeps ``prefetch`` batches ready (host-side input
    pipeline overlap, same role as Hadoop's input readers in the paper's
    stack).  ``start_step`` resumes a restarted run mid-stream.
    """

    def __init__(self, cfg: PipelineConfig, start_step: int = 0,
                 prefetch: int = 2) -> None:
        self.cfg = cfg
        self._step = start_step
        self._q: "queue.Queue[Dict[str, np.ndarray]]" = queue.Queue(prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = make_batch(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self._q.get()
        self._step += 1
        return batch

    def close(self) -> None:
        self._stop.set()
