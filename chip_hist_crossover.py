#!/usr/bin/env python3
"""Where one cluster stops beating a grid, and what a call costs the host,
for the histogram kernel on one GPU.

    python3 chip_hist_crossover.py

Run from the root of a checkout on an H100 (or another sm_90a card).  It
builds ``src/repro_torch/csrc/bucket_histogram.cu`` as shipped and runs it
through the wrapper's own launch entry:

1. the one-cluster crossover: N from 2^16 to 2^20 keys (10 % padding, 1 %
   >= n_buckets) into 4 buckets (the ``regs`` route, the main path's) and
   128 (``smem``), each as the plan's one cluster (one launch, no memset)
   and as a grid of clusters over the card (a memset and a launch), the
   plan forced, timed one cluster, grid, grid, one cluster; every result
   equal to ``torch.bincount``;
2. the host time a call: 2000 calls enqueued back to back at the main
   path's shape (131,032 keys, 4 buckets), beside a one-element ``add_``
   and ``torch.bincount``.

Device ms is the profiler's device time a call over 15 calls (kernel and
memset: ``chip_smoke.device_profile``); event ms is CUDA events around
each call, median of 15 after 3 warm-ups (``chip_smoke.time_ms``).  It
prints the card's name and power limit, one JSON line per measurement,
and per route the largest N of the sweep at which one cluster is no
slower than the grid, beside the wrapper's ``CROSSOVER``.  It exits
non-zero without a card or if a result disagrees.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
LOG2_N = (16, 17, 17.5, 17.75, 18, 18.25, 18.5, 19, 20)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_hist_crossover: no CUDA device; this script runs on the "
              "GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import bucket_histogram as bh

    print(cs._card(), flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    launch = bh._launcher().launch
    sms, optin = bh._configure(0)
    ok = True

    def keys_for(n_buckets: int, n: int) -> torch.Tensor:
        keys = torch.randint(0, n_buckets, (n,), generator=g, device=dev,
                             dtype=torch.int32)
        u = torch.rand(n, generator=g, device=dev)
        keys[u < 0.10] = -1
        keys[(u >= 0.10) & (u < 0.11)] = n_buckets + 7
        return keys

    def run_plan(keys: torch.Tensor, n_buckets: int, plan) -> dict:
        nonlocal ok
        struct = bh._struct(plan)

        def run():
            out = keys.new_empty(n_buckets)
            err = launch(ctypes.addressof(struct), keys.data_ptr(), keys.numel(),
                         n_buckets, out.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed ({err}) for {plan}")
            return out

        want = torch.bincount(keys[(keys >= 0) & (keys < n_buckets)],
                              minlength=n_buckets).int()
        equal = torch.equal(run(), want)
        ok &= equal
        dev_ms, ops, _ = cs.device_profile(run, op_keys=cs.OP_KEYS)
        return {"device_ms": dev_ms, "device_ops_per_call": ops,
                "event_ms": cs.time_ms(run), "equal": equal}

    for n_buckets in (4, 128):  # 1. the crossover
        wins = []
        for log2 in LOG2_N:
            n = int(2 ** log2)
            keys = keys_for(n_buckets, n)
            plan = bh._plan(n, n_buckets, sms, optin)
            blocks = min(bh.MAX_CLUSTER, max(1, -(-n // bh.KEYS_PER_BLOCK)))
            one = plan._replace(single=True, cluster=blocks, grid=blocks)
            grid = plan._replace(single=False, cluster=bh.GRID_CLUSTER,
                                 grid=sms // bh.GRID_CLUSTER * bh.GRID_CLUSTER)
            runs = {"one_cluster": [], "grid": []}
            for name in ("one_cluster", "grid", "grid", "one_cluster"):
                runs[name].append(run_plan(keys, n_buckets,
                                           one if name == "one_cluster" else grid))
            row = {"study": "crossover", "route": plan.route, "n": n,
                   "log2_n": log2, "n_buckets": n_buckets}
            for name, rs in runs.items():
                row[name] = {
                    "device_ms": statistics.mean(r["device_ms"] for r in rs),
                    "event_ms": statistics.mean(r["event_ms"] for r in rs),
                    "device_ops_per_call": rs[0]["device_ops_per_call"],
                    "device_ms_runs": [r["device_ms"] for r in rs],
                }
            print(json.dumps(row), flush=True)
            if row["one_cluster"]["device_ms"] <= row["grid"]["device_ms"]:
                wins.append(n)
        print(json.dumps({"study": "crossover", "route": plan.route,
                          "n_buckets": n_buckets,
                          "largest_n_one_cluster_no_slower": max(wins, default=0),
                          "one_cluster_no_slower_at": wins,
                          "wrapper_crossover": bh.CROSSOVER}), flush=True)
        del keys
    torch.cuda.empty_cache()

    keys = torch.randint(-1, 4, (131_032,), generator=g, device=dev,
                         dtype=torch.int32)
    one = torch.zeros(1, device=dev)
    for name, fn in (("bucket_histogram", lambda: bh.bucket_histogram(keys, 4)),
                     ("add_ on one element", lambda: one.add_(1)),
                     ("torch.bincount", lambda: torch.bincount(keys[keys >= 0],
                                                               minlength=4))):
        fn()  # 2. the host time a call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        host_us = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
        print(json.dumps({"study": "host time", "call": name, "n": 131_032,
                          "host_us_per_call": host_us}), flush=True)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
