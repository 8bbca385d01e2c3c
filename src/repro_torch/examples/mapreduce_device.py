"""Fourth example: the device-resident shuffle (DESIGN.md §2).

Runs the same WordCount three ways and prints what moved where:
  1. device path — map/shuffle/reduce entirely on the card, the counts
     reduced by the ``bucket_histogram`` kernel; the Marvel/IGFS fast tier
     re-derived for the accelerator's memory hierarchy,
  2. host-tier path — the same computation with the shuffle spilled to a
     host storage tier (the Corral/S3 pattern),
  3. modeled S3 — the host path billed at AWS-like bandwidth/latency.

The port of ``examples/mapreduce_device.py`` for one card: one owner, the
same plan and the same numbers (the reference's mesh spans its devices; on
one card the call takes no mesh).  It runs on the card unless ``--device
cpu`` is given, where the kernel runs its plain version.

Usage:  PYTHONPATH=src python -m repro_torch.examples.mapreduce_device \\
            [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.api import ClusterConfig, MarvelClient
from repro_torch.core import device_histogram, host_histogram, storage_histogram

__all__ = ["main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = torch.device(ap.parse_args(argv).device)

    rng = np.random.default_rng(0)
    vocab, n = 8192, 1 << 16
    keys = rng.integers(0, vocab, n).astype(np.int32)  # token ids = words
    vals = np.ones(n, np.float32)
    print(f"wordcount over {n} tokens, vocab {vocab}, 1 device(s)\n")

    k, v = torch.from_numpy(keys).to(device), torch.from_numpy(vals).to(device)
    _sync(device)
    t0 = time.perf_counter()
    res = device_histogram(k, v, vocab=vocab, capacity_factor=2.0, device=device,
                           unit_weights=True)
    _sync(device)
    t_dev = time.perf_counter() - t0
    print(f"device path:   {t_dev*1e3:7.1f} ms  "
          f"(shuffle stayed in HBM/ICI: {res.shuffled_bytes/1e6:.1f} MB, "
          f"{int(res.dropped)} dropped)")

    with MarvelClient(ClusterConfig(name="dev-host")) as client:
        t0 = time.perf_counter()
        res2 = storage_histogram(keys, vals, 8, client.state, vocab=vocab,
                                 capacity_factor=2.0, device=device)
        t_host = time.perf_counter() - t0
    print(f"host-tier path:{t_host*1e3:7.1f} ms  "
          f"(device->host->device round trip)")

    with MarvelClient(ClusterConfig(name="dev-s3", tiers=("s3",),
                                    journal="none")) as client:
        res3 = storage_histogram(keys, vals, 8, client.state, vocab=vocab,
                                 capacity_factor=2.0, device=device)
        s3_modeled = client.state.stats.modeled_seconds
    print(f"modeled S3:    {(t_host + s3_modeled)*1e3:7.1f} ms  "
          f"(+{s3_modeled*1e3:.0f} ms of modeled object-store "
          f"I/O)")

    # the counts are whole numbers below 2^24, exact in f32: held equal
    counts = [r.counts.cpu().numpy() for r in (res, res2, res3)]
    for other in counts[1:] + [host_histogram(keys, vals, vocab)]:
        np.testing.assert_array_equal(counts[0], other)
    print("\nall three paths agree with each other (and the oracle).")
    return {"counts": counts[0], "dropped": int(res.dropped),
            "shuffled_bytes": res.shuffled_bytes, "device_s": t_dev,
            "host_s": t_host, "s3_modeled_s": s3_modeled}


if __name__ == "__main__":
    main()
