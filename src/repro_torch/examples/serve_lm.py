"""Stateful LM serving through Marvel-Serve (DESIGN.md §14).

Dozens of concurrent conversations — Zipf-skewed activity, so a few are
hot and the long tail is mostly idle — decode through a
:class:`~repro_torch.serving.ServingPool` built by ``client.serving()``.
Each conversation's KV cache is paged at (session, layer, block)
granularity through the tier hierarchy: the warm set stays pinned in
DRAM, warm-pool evictions demote the victim's blocks to the PMEM level
instead of dropping them, and a resumed conversation's blocks are
promoted back in the background ahead of its next token.

A "server restart" is just a second MarvelClient over the same durable
config: the pager re-adopts every session from the PMEM tier and decode
continues mid-conversation, byte-identical (the pool below runs
``lossless=True`` demotion).

The port of ``examples/serve_lm.py``: the same trace, cluster and pool,
with the prefill and decode on the card (the flash and decode kernels)
unless ``--device cpu`` is given.  :func:`run` takes the weights and the
prompts, so that any model and draw can be served; the CLI serves
qwen2.5-3b with weights and prompts drawn from an explicit generator: on
the CPU the reference's ``reduced_for_smoke`` model, on the card the full
width (the kernels take head dims 64, 128 and 256, not the reduced
model's 16).  The PMEM and journal directories are made under a
temporary directory and removed at the end.

Usage:  PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
            [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.api import ClusterConfig, MarvelClient, ServingConfig, TierSpec
from repro_torch.configs import get_config
from repro_torch.core.loadgen import TraceSpec, generate_trace
from repro_torch.models import init_params, model_defs, reduced_for_smoke

__all__ = ["TRACE", "PROMPT_LEN", "GEN_LEN", "conversations", "cluster_config",
           "run", "main"]

# Zipf-active conversations: 2 tenants x 12 sessions, skewed so the head
# sessions get most of the decode traffic.
TRACE = TraceSpec(seed=7, duration=6.0, base_rate=24.0, tenants=2,
                  sessions_per_tenant=12, zipf_skew=0.9, session_skew=0.9)
PROMPT_LEN, GEN_LEN = 8, 16


def conversations() -> tuple:
    """The trace's arrivals and its conversations' ids, sorted."""
    arrivals = list(generate_trace(TRACE))
    return arrivals, sorted({f"{a.tenant}-{a.session}" for a in arrivals})


def cluster_config(workdir: Path) -> ClusterConfig:
    """Capped DRAM over a real PMEM level, PMEM journal, and a warm pool
    far smaller than the conversation count — the pager, not the pool, is
    what keeps the tail resumable."""
    return ClusterConfig(
        name="serve",
        tiers=(TierSpec("dram", capacity_bytes=64 << 20),
               TierSpec("pmem", path=str(workdir / "kv"))),
        invokers=2, warm_pool=8, commit_every=1,
        journal="pmem",
        journal_path=str(workdir / "journal"),
        serving=ServingConfig(block_tokens=8, lossless=True),
    )


def _prompt(tokens: Any, device: torch.device) -> torch.Tensor:
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.array(tokens, dtype=np.int32))
    return tokens.to(device, torch.int32)


def _first(token: Any) -> int:
    return int(torch.as_tensor(token).reshape(-1)[0])


def run(
    cfg: Any,
    params: Any,
    prompts: Mapping[str, Any],
    device: Any = "cuda",
    *,
    label: str = "CPU reduced model",
    workdir: Optional[Path] = None,
    log: Callable[[str], None] = print,
) -> Dict[str, Any]:
    """Serve the trace with ``params`` (on ``device``), each conversation
    starting from ``prompts[conversation]`` ((1, PROMPT_LEN) token ids),
    GEN_LEN tokens at most, then restart and decode one more token.  ``workdir``
    holds the PMEM level and the journal (default: a temporary directory,
    removed at the end).  Returns each conversation's tokens, the pool's
    stats, the hottest conversation, the sessions re-adopted after the
    restart, the conversation resumed then and its next token, and the
    decode's seconds and tokens per second."""
    device = torch.device(device)
    arrivals, _ = conversations()
    own = workdir is None
    workdir = Path(tempfile.mkdtemp(prefix="marvel_serve_")) if own else Path(workdir)
    cluster = cluster_config(workdir)
    try:
        with MarvelClient(cluster) as client:
            pool = client.serving(params, cfg, prompt_len=PROMPT_LEN,
                                  max_tokens=GEN_LEN, device=device)
            t0 = time.perf_counter()
            tokens = collections.defaultdict(list)
            started = set()
            for a in arrivals:
                c = f"{a.tenant}-{a.session}"
                if len(tokens[c]) >= GEN_LEN:
                    continue
                if c not in started:
                    fut = pool.start(c, _prompt(prompts[c], device))
                    started.add(c)
                else:
                    if not pool.is_resident(c):
                        pool.resume(c)  # promote blocks ahead of the step
                    fut = pool.step(c)
                tokens[c].append(_first(fut.result()))
            dt = time.perf_counter() - t0

            stats = pool.stats()
            total = sum(len(v) for v in tokens.values())
            log(f"{total} tokens across {len(started)} Zipf-active "
                f"conversations in {dt:.2f}s ({total / dt:.1f} tok/s, "
                f"{label})")
            log(f"pager: {stats['resident_sessions']} resident / "
                f"{stats['paged_sessions']} paged sessions, "
                f"{stats['demotions']} demotions, "
                f"{stats['resumes']} resumes, "
                f"{stats['demand_faults']} demand faults")
            hot = max(tokens, key=lambda c: len(tokens[c]))
            log(f"hottest conversation {hot}: "
                f"{tokens[hot][:8]} ... ({len(tokens[hot])} tokens)")
            for c in sorted(started)[:3]:
                pool.suspend(c)  # push cold; blocks now live in PMEM only
            client.runtime.commit_all()
            pool.pager.sync()

        # Server restart: fresh client, same durable config.  The pager
        # re-adopts sessions from the PMEM tier; lossless demotion makes
        # the resumed decode byte-identical to an uninterrupted one.
        with MarvelClient(cluster) as client:
            pool = client.serving(params, cfg, prompt_len=PROMPT_LEN,
                                  max_tokens=GEN_LEN, device=device)
            adopted = pool.pager.recover()
            resumed = sorted(pool.conversations())[0]
            pool.resume(resumed)
            nxt = torch.as_tensor(pool.step(resumed).result()).cpu()
            log(f"after restart ({adopted} sessions re-adopted from PMEM), "
                f"next token for {resumed}: {nxt[0].tolist()} "
                f"(conversation state survived)")
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
    return {"tokens": dict(tokens), "conversations": len(started),
            "stats": stats, "hot": hot, "adopted": adopted, "resumed": resumed,
            "next_token": nxt[0].tolist(), "decode_s": dt,
            "tokens_per_s": total / dt}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = torch.device(ap.parse_args(argv).device)

    cfg = get_config("qwen2.5-3b")
    full = device.type != "cpu"
    if not full:
        cfg = reduced_for_smoke(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(model_defs(cfg), gen, device)
    _, convs = conversations()
    prompts = {c: torch.randint(0, cfg.vocab, (1, PROMPT_LEN), generator=gen,
                                device=device, dtype=torch.int32)
               for c in convs}
    where = "CPU" if device.type == "cpu" else "GPU"
    size = "full-width" if full else "reduced"
    return run(cfg, params, prompts, device, label=f"{where} {size} model")


if __name__ == "__main__":
    main()
