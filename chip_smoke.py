#!/usr/bin/env python3
"""Drive Marvel's PyTorch/CUDA port on one GPU and check what comes out.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with an NVIDIA H100 (or
another sm_90a card).  It builds the port's CUDA kernels from
``src/repro_torch/csrc`` with ``nvcc`` into ``build/repro_torch/``, then:

1. prints the card's name and power limit, the torch and CUDA versions
   and the kernel build time; then makes the first launches of the flash,
   decode and SSD kernels (bf16 and f32) from 4 threads released at once,
   which races each kernel's per-device setup: every thread's output must
   be the bytes of a later call, which must match the plain version;
2. holds ``bucket_histogram`` against its plain PyTorch version and
   ``torch.bincount`` on the card, exactly: the contract's edge cases;
   every route edge (n_buckets in {1, 4, 16, 17, 58112, 58113, 131072,
   929792, 929793}, each below and above the one-cluster crossover); N in
   {1, 3, an unaligned view of 4099, 131032, the crossover - 1, itself and
   + 1}; all keys in one bucket; then 2^28 int32 keys (1 GiB, 10 %
   padding, 1 % >= n_buckets) for n_buckets in {4, 128, 32000, 131072}
   and 2^28 Zipf(1.1) keys over 32000, each with the kernel's route,
   event-timed and profiler device time, device operations a call, the
   plain version's and ``torch.bincount``'s times (CUDA events, median of
   15 after warm-up) beside the memory bound.  Every route (``regs``,
   ``smem``, ``global``) must have run;
3. runs ``device_histogram`` over 2^28 Zipf tokens (vocab 32000) against
   ``host_histogram``, and ``storage_histogram`` (8 shards through a DRAM
   tier) over 2^24 of them against the device result;
4. drives the main path, ``MarvelClient`` in device mode: WordCount over a
   64 MiB Zipf(0.5) corpus (the paper runs 1-15 GB; 64 MiB is what the
   host-side Python mapper gets through within the time limit), TeraSort
   over 2^19 100-byte records, WordCount again with capacity spill, and
   WordCount over a Zipf(1.1) corpus, whose reduces fall back to the host.
   Each output must be byte-identical to the same job in host mode, the
   first WordCount must reduce wholly on the device, and every kernel
   must have launched during this phase;
5. times ``bucket_histogram`` at the main path's largest shape, beside
   a launch floor (a one-element ``add_``): there a call must be one
   device operation, and a profiled window of 15 calls must show no
   device-attribute, function-attribute or occupancy query (a first call,
   profiled with the caches cleared, shows the profiler records them);
6. holds ``flash_attention`` and ``decode_attention`` against their plain
   versions (run in f32; tolerance 2e-2 for bf16, 2e-5 for f32) on the
   card: flash prefill at B=1, T=1024, H=16, Kv=2, dh=128, causal, then
   ragged T, T=1, softcap, dh 64 and 256 (and 256 with a window), MHA,
   non-causal, a window, f32 and f16, T in {63, 64, 65, 127, 129} causal
   and with a window (the edges of the 64-row tiles), Tq < Tk and Tq > Tk;
   every flash case on the route its type must take (tensor cores for
   bf16/f16) and run twice for the same bytes; a view whose strides TMA
   cannot take must raise ``ValueError``; decode over S=1088 at every
   length from 1 to S, rep 8 and 1, dh 64, 128 and 256, softcap, a batch
   of 8 with mixed lengths, f32, a zero length (zeros out), and decode
   captured alone in a CUDA graph and replayed with new lengths (the
   bytes of the eager call);
7. drives the serving path, ``MarvelClient.serving`` over a DRAM + PMEM
   tier stack with a PMEM journal, at the full width of qwen2.5-3b (36
   layers, d_model 2048, 16 heads over 2 kv heads, vocab 151936; random
   bf16 weights drawn on the card from ``--seed``), prompts of 1024
   tokens and 64 tokens of headroom: 8 conversations interleaved over a
   warm pool of 4, so evictions demote their KV caches to int8 and their
   next steps decode from it (tokens per second printed); a lossless pool
   where a conversation suspended to PMEM and resumed decodes the same
   tokens and leaves byte-identical block blobs as one never suspended; a
   restart (a second client over the same durable config) that re-adopts
   every session and decodes on exactly as the uninterrupted run; and
   decode-step logits against a fresh prefill over the same tokens
   (relative L2 error <= 2e-2).  Both attention kernels must have
   launched after the resume and after the restart;
8. replays a seeded multi-tenant trace (``core/loadgen.py``) at
   ``MarvelClient.serving`` over phase 7's weights: 3 tenants (Zipf 0.8)
   of 4 conversations, 12 s, a 4x burst on t0 from 4 s for 3 s, the base
   rate half the hot steps per second one invoker sustained in phase 7's
   lossless pool; a lossless pool over a warm pool of 4, so evictions
   demote while other conversations decode.  Cell ``fixed`` has one
   invoker; cell ``auto`` runs under ``MarvelClient.autoscaler`` (1 to 4
   invokers, pumped from the replay), so decode steps and demotions run on
   several invoker threads at once.  Each cell prints its p99 latency per
   tenant and overall, windowed p99-under-SLO share (1000 ms, 1 s
   windows), goodput, sheds, decode tokens per second, scale actions,
   peak invokers, t0's isolation ratio and the KV pressure; it must have
   no error, conserve every tenant's counts, and launch flash 36 times a
   conversation started and decode 36 times a step; ``auto`` must scale
   up, reach 2 invokers or more and come back to 1 after the drain.
   Every conversation's tokens must equal the same conversation's served
   alone in a fresh pool;
9. holds ``ssd_chunk`` (the Mamba-2 SSD within-chunk kernel) against its
   plain version (tolerance 2e-3 abs and rel; every case run twice and
   compared bit for bit): the prefill's shape (BC=4, Q=256, H=80, P=64,
   N=128, B/C one group read with a head stride of 0, which must give
   the bytes of a per-head copy), per-head B/C, Q in {1, 37}, H=6 and
   H=13 (no multiple of a block's heads), P and N over {16, 32, 64, 128},
   and a strongly negative dA_cs whose upper-triangle exp overflows in
   the exp-then-mask oracle;
10. drives ``MarvelClient.serving`` over Mamba-2 at the full width of
   mamba2-2.7b (64 SSD layers, d_model 2560, 80 heads of 64, d_state
   128, chunk 256, vocab 50280; random bf16 weights drawn on the card
   from ``--seed``, dt, A and the output projection as Mamba-2's
   published init sets them), prompts of 1024 tokens, the same tier
   stack and journal: 4 conversations interleaved over a warm pool of 2, so every step evicts a conversation's recurrent state
   (64 x 80 x 64 x 128 f32, 168 MB, and a 2 MB conv window) to PMEM and
   resumes another onto the card; lossless suspend/resume byte
   identity; a restart that re-adopts every session; decode-step logits
   (the recurrent form) against a fresh prefill over 1024 plus the new
   tokens (the kernel, with the chunk padding), relative L2 <= 2e-2 with
   the served weights computed in f32 (the bf16 error, which this random
   64-layer model amplifies to a few percent, is printed beside it).
   The SSD kernel must have launched after the resume and after the
   restart;
11. prints a ``kernels`` JSON line: each kernel's launches on its path
   (counts set to 0 just before the path runs and read just after), its
   checks and largest error, and its times at its path's shape beside
   the plain version's, the PyTorch library call's (``torch.bincount``,
   ``scaled_dot_product_attention``; a yardstick only; none computes the
   SSD chunk) and the bound; every row also carries its kernel route and
   its device-only time from the profiler (and the library call's for
   the histogram, flash and decode; flash and decode also carry their
   launches on phase 8's path), since an event-timed ``ms`` includes
   the wrapper's host time.  Decode and SSD must make one launch a call, of
   their own kernel.

The build prints ptxas's registers, shared memory and spills for every
kernel, and fails if a flash, decode or SSD kernel spills.  The serving
phases' profiles also read one prefill's device time and the flash and
SSD kernels' shares of it, and a decode step's launches and decode
kernels.

Every check that fails raises, and the script exits non-zero.  The last
line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
rest of the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core peak, the f32 inputs' type
REPS = 15
# Sizes of the run (see the module docstring for why these).
KERNEL_KEYS = 1 << 28  # 1 GiB of int32 keys
SHUFFLE_TOKENS = 1 << 28  # 1 GiB of tokens plus 1 GiB of values
STORAGE_TOKENS = 1 << 24
CORPUS_BYTES = 64 << 20
TERASORT_RECORDS = 1 << 19
SERVE_MODEL = "qwen2.5-3b"  # full width: 36 layers, d_model 2048, GQA 16/2
SERVE_PROMPT = 1024
SERVE_MAX_TOKENS = 64
SERVE_CONVS = 8  # twice the warm pool, so evictions demote to int8
INT8_STEPS = 6  # decode steps per conversation in the int8 pool
LOSSLESS_STEPS = 16  # decode steps of the lossless identity check
SSM_MODEL = "mamba2-2.7b"  # full width: 64 layers, d_model 2560, 80 heads of 64
SSM_PROMPT = 1024
SSM_MAX_TOKENS = 32
SSM_CONVS = 4  # twice the warm pool of 2, so every step evicts and resumes
SSM_STEPS = 3  # interleaved decode steps per conversation
SSM_LOSSLESS_STEPS = 8


class SmokeError(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bytes_bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# -- phase 1b: first launches from several threads at once -------------------

FIRST_LAUNCH_THREADS = 4


def phase_first_launch_threads(dev, seed: int) -> None:
    """The first launches in this process of the flash, decode and SSD
    kernels (bf16 and f32 routes), made by several threads released at
    once: each kernel sets its attributes on its first launch on a device,
    so this races that setup.  Every thread's output must be the bytes of
    a later call on the main thread, which must match the plain version."""
    import threading

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan

    g = torch.Generator(device=dev).manual_seed(seed + 11)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = flash_inputs(g, dev, 1, 128, 16, 2, 128, dtype)
        cases.append((f"flash_{str(dtype)[6:]}", fa.flash_attention, (q, k, v)))
        lengths = torch.tensor([100, 256], dtype=torch.int32, device=dev)
        dargs = (_randn(g, (2, 16, 128), dtype, dev),
                 _randn(g, (2, 256, 2, 128), dtype, dev),
                 _randn(g, (2, 256, 2, 128), dtype, dev), lengths)
        cases.append((f"decode_{str(dtype)[6:]}", da.decode_attention, dargs))
    cases.append(("ssd_chunk", ssd_scan.ssd_chunk_fwd,
                  ssd_inputs(g, dev, 2, 64, 8, 64, 128)))
    torch.cuda.synchronize()
    barrier = threading.Barrier(FIRST_LAUNCH_THREADS)
    outs = [None] * FIRST_LAUNCH_THREADS
    failures = []

    def run(i: int) -> None:
        try:
            barrier.wait()
            outs[i] = [fn(*args) for _, fn, args in cases]
            torch.cuda.synchronize()
        except BaseException as exc:  # reported below, on the main thread
            failures.append(f"thread {i}: {exc!r}")

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(FIRST_LAUNCH_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not failures, f"first launches from {FIRST_LAUNCH_THREADS} "
          f"threads failed: {failures}")
    flash_rec, decode_rec, ssd_rec = (AttnRecord("flash_attention"),
                                      AttnRecord("decode_attention"), SSDRecord())
    errs = {}
    for c, (case, fn, args) in enumerate(cases):
        again = fn(*args)
        for i in range(FIRST_LAUNCH_THREADS):
            got = outs[i][c]
            same = (all(torch.equal(a, b) for a, b in zip(got, again))
                    if isinstance(got, tuple) else torch.equal(got, again))
            check(same, f"{case}: thread {i}'s first launch gave other bytes "
                  "than a later call")
        if case.startswith("flash"):
            q, k, v = args
            errs[case] = flash_rec.compare(case, again, fa.flash_attention_torch(
                q.float(), k.float(), v.float()), q.dtype)
        elif case.startswith("decode"):
            q, kc, vc, lengths = args
            errs[case] = decode_rec.compare(case, again, da.decode_attention_torch(
                q.float(), kc.float(), vc.float(), lengths), q.dtype)
        else:
            errs[case] = ssd_rec.compare(case, args)
    emit("first_launch_threads", threads=FIRST_LAUNCH_THREADS,
         max_abs_err=errs, identical_across_threads=True, ok=True)


# -- phase 2: the kernel against its plain version ----------------------------

class KernelRecord:
    """What the ``kernels`` line reports for ``bucket_histogram``, and the
    routes its checks ran."""

    def __init__(self) -> None:
        self.max_abs_err = 0
        self.checks = 0
        self.routes: set = set()

    def compare(self, keys: torch.Tensor, n_buckets: int) -> torch.Tensor:
        from repro_torch.kernels import bucket_histogram as bh

        got = bh.bucket_histogram(keys, n_buckets)
        plain = bh.bucket_histogram_torch(keys, n_buckets)
        valid = keys[(keys >= 0) & (keys < n_buckets)]
        library = torch.bincount(valid, minlength=n_buckets)
        torch.cuda.synchronize()
        err = int((got.long() - plain.long()).abs().max())
        self.max_abs_err = max(self.max_abs_err, err)
        self.checks += 1
        self.routes.add(hist_plan(keys, n_buckets).route)
        check(got.dtype == torch.int32 and got.shape == (n_buckets,),
              f"kernel output {got.dtype} {tuple(got.shape)}")
        check(torch.equal(got, plain), f"kernel != plain (n={keys.numel()}, "
              f"n_buckets={n_buckets}, max abs err {err})")
        check(torch.equal(got.long(), library),
              f"kernel != torch.bincount (n={keys.numel()}, n_buckets={n_buckets})")
        return got

    def measure(self, keys: torch.Tensor, n_buckets: int) -> dict:
        """The kernel's route, event-timed and device time and device
        operations a call, the plain version's and ``torch.bincount``'s
        times, and the bound (the keys read and the counts written once)."""
        from repro_torch.kernels import bucket_histogram as bh

        self.compare(keys, n_buckets)
        valid = keys[(keys >= 0) & (keys < n_buckets)]
        kernel = lambda: bh.bucket_histogram(keys, n_buckets)  # noqa: E731
        library = lambda: torch.bincount(valid, minlength=n_buckets)  # noqa: E731
        before = bh.launches
        kernel_ms = time_ms(kernel)
        launches = bh.launches - before
        dev_ms, ops, _ = device_profile(kernel, op_keys=OP_KEYS)
        plain_ms = time_ms(lambda: bh.bucket_histogram_torch(keys, n_buckets))
        library_ms = time_ms(library)
        n = keys.numel()
        plan = hist_plan(keys, n_buckets)
        return {
            "n": n, "n_buckets": n_buckets, "kernel_route": plan.route,
            "one_cluster": plan.single, "kernel_ms": kernel_ms,
            "device_ms": dev_ms, "device_ops_per_call": ops,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_ms": device_ms(library),
            "bound_ms": bytes_bound_ms(4 * n + 4 * n_buckets),
            "bound_by": "bytes", "launches": launches,
        }


def hist_plan(keys: torch.Tensor, n_buckets: int):
    """The plan ``bucket_histogram`` runs for these keys (prepared by the
    call before it)."""
    from repro_torch.kernels import bucket_histogram as bh

    return bh._call_for(keys.get_device(), keys.numel(), n_buckets).plan


#: n_buckets at the edges of the histogram's routes: regs up to 16, smem
#: up to what one block's shared memory holds (58112 on the H100), global
#: above it (and past 16 blocks of it)
HIST_ROUTE_EDGES = (1, 4, 16, 17, 58112, 58113, 131072, 929792, 929793)


def phase_kernel(dev, seed: int, rec: KernelRecord, n: int) -> None:
    from repro_torch.kernels import bucket_histogram as bh

    g = torch.Generator(device=dev).manual_seed(seed)

    def randint(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, device=dev,
                             dtype=torch.int32)

    exact = torch.zeros((1 << 24) + 65, dtype=torch.int32, device=dev)
    exact[-64:] = 2
    edges = {
        "empty": (torch.zeros(0, dtype=torch.int32, device=dev), 8),
        "below_block": (randint(-1, 8, 5), 8),
        "all_padding": (torch.full((64,), -1, dtype=torch.int32, device=dev), 8),
        "over_range": (randint(-3, 20, 777), 8),
        "unaligned_view": (randint(-1, 9, 4099)[3:], 8),
        "global_70000": (randint(-1, 70000, 100003), 70000),
    }
    for name, (keys, nb) in edges.items():
        got = rec.compare(keys.contiguous(), nb)
        emit("kernel_edge", case=name, n=keys.numel(), n_buckets=nb, ok=True,
             total=int(got.sum()))
    got = rec.compare(exact, 4)
    check(int(got[0]) == (1 << 24) + 1, "int32 count past 2^24 is not exact")
    emit("kernel_edge", case="exact_past_2^24", n=exact.numel(), n_buckets=4,
         ok=True, count=int(got[0]))
    f32 = bh.bucket_histogram(exact, 4, out_dtype=torch.float32)
    check(f32.dtype == torch.float32, "out_dtype float32 ignored")
    del exact

    # every route edge, as one cluster and as a grid of clusters
    over = 4 * bh.CROSSOVER + 5
    for nb in HIST_ROUTE_EDGES:
        for m in (100003, over):
            keys = randint(-1, nb + nb // 50 + 2, m)
            rec.compare(keys, nb)
            plan = hist_plan(keys, nb)
            emit("kernel_edge", case="route_edge", n=m, n_buckets=nb,
                 route=plan.route, one_cluster=plan.single, ok=True)
    # N at its edges: tiny, unaligned, the main path's, the crossover
    sizes = {"1": (1, 0), "3": (3, 0), "unaligned_4099": (4099, 3),
             "131032": (131032, 0)}
    for d in (-1, 0, 1):
        sizes[f"crossover{d:+d}"] = (bh.CROSSOVER + d, 0)
    for name, (m, offset) in sizes.items():
        for nb in (4, 17, 131072, 929793):
            keys = randint(-1, nb + 2, m + offset)[offset:]
            rec.compare(keys, nb)
        emit("kernel_edge", case=f"n_{name}", n=m, ok=True,
             one_cluster=hist_plan(keys, 4).single)
    card = bh._devices[dev.index]
    check(bh._plan(bh.CROSSOVER, 4, *card).single
          and not bh._plan(bh.CROSSOVER + 1, 4, *card).single,
          "the one-cluster crossover is not where the plan says")
    # worst contention: every key in one bucket
    for nb in (4, 128, 131072, 929793):
        keys = torch.full((1 << 22,), min(nb - 1, 5), dtype=torch.int32,
                          device=dev)
        rec.compare(keys, nb)
        emit("kernel_edge", case="one_bucket", n=keys.numel(), n_buckets=nb,
             route=hist_plan(keys, nb).route, ok=True)
    del keys
    torch.cuda.empty_cache()

    for nb in (4, 128, 32000, 131072, "zipf"):
        if nb == "zipf":  # Zipf(1.1): about 14 % of the keys hit bucket 0
            nb, keys = 32000, zipf_tokens(n, 32000, g, dev)
            label = "zipf1.1"
        else:
            keys = randint(0, nb, n)
            u = torch.rand(n, generator=g, device=dev)
            keys[u < 0.10] = -1  # padding
            keys[(u >= 0.10) & (u < 0.11)] = nb + 7  # dropped: >= n_buckets
            del u
            label = "uniform"
        emit("kernel", keys=label, **rec.measure(keys, nb))
        del keys
        torch.cuda.empty_cache()
    check(rec.routes == {"regs", "smem", "global"},
          f"bucket_histogram routes checked: {sorted(rec.routes)}")


def hist_at_main_shape(rec: KernelRecord, largest: dict) -> dict:
    """``bucket_histogram`` at the main path's largest shape, beside a
    launch floor: one call must be one device operation, and a window of
    15 calls must make no device-attribute, function-attribute or
    occupancy query (and no call of the wrapper's own per-device set-up),
    where a first call with the caches cleared shows that the profiler
    records such queries."""
    from repro_torch.kernels import bucket_histogram as bh

    keys, nb = largest["dest"], largest["n_parts"]
    shape = rec.measure(keys, nb)
    floor = torch.zeros(1, device=keys.device)
    add = lambda: floor.add_(1)  # noqa: E731
    shape["launch_floor_ms"] = time_ms(add)
    shape["launch_floor_device_ms"] = device_ms(add)

    def queries(events) -> list:
        return sorted({e.key for e in events if e.key.startswith(QUERY_KEYS)})

    bh._devices.clear()
    bh._calls.clear()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        bh.bucket_histogram(keys, nb)
        torch.cuda.synchronize()
    first = queries(prof.key_averages())
    setups = []
    real = bh._configure
    bh._configure = lambda *a: setups.append(a) or real(*a)
    try:
        events, _, _ = profile_window(lambda: bh.bucket_histogram(keys, nb))
    finally:
        bh._configure = real
    window = queries(events)
    check(bool(first), "the profiler recorded no query of a first call: "
          "the window's check would see nothing")
    shape.update(queries_first_call=first, queries_in_window=window,
                 setups_in_window=len(setups))
    check(shape["device_ops_per_call"] == 1,
          f"bucket_histogram made {shape['device_ops_per_call']} device "
          "operations a call at the main path's shape: want 1")
    check(not window and not setups,
          f"bucket_histogram queried the device per call: {window}, "
          f"{len(setups)} set-ups")
    return shape


# -- phase 3: the device shuffle -----------------------------------------------

def zipf_tokens(n: int, vocab: int, g, dev, a: float = 1.1) -> torch.Tensor:
    """Zipf(a) ranks truncated to ``vocab``, by inverse CDF on the device."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=dev)
    cdf = torch.cumsum(ranks ** -a, 0)
    cdf = (cdf / cdf[-1]).float()
    u = torch.rand(n, generator=g, device=dev)
    return torch.searchsorted(cdf, u, out_int32=True).clamp_(max=vocab - 1)


def phase_shuffle(dev, seed: int, n: int, n_storage: int) -> None:
    from repro_torch.core.device_shuffle import (
        device_histogram, host_histogram, storage_histogram,
    )
    from repro_torch.storage import DramTier

    vocab = 32000
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    keys = zipf_tokens(n, vocab, g, dev)
    values = torch.ones(n, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = device_histogram(keys, values, 1, vocab=vocab, device=dev)
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    keys_h, values_h = keys.cpu().numpy(), values.cpu().numpy()
    t0 = time.perf_counter()
    want = host_histogram(keys_h, values_h, vocab)
    host_s = time.perf_counter() - t0
    got = res.counts.cpu().numpy()
    check(got.dtype == np.int32 and got.shape == (vocab,),
          f"device_histogram counts {got.dtype} {got.shape}")
    check(np.array_equal(got, want), "device_histogram != host_histogram")
    check(int(res.dropped) == 0, f"device_histogram dropped {int(res.dropped)}")
    emit("device_histogram", tokens=n, vocab=vocab, wall_s=device_s,
         host_histogram_s=host_s, shuffled_bytes=res.shuffled_bytes,
         buffer_bytes=res.buffer_bytes, dropped=int(res.dropped), equal=True)
    del res, values
    torch.cuda.empty_cache()

    sub = keys[:n_storage]
    ones = torch.ones(n_storage, dtype=torch.int32, device=dev)
    dev_res = device_histogram(sub, ones, 1, vocab=vocab, device=dev)
    tier = DramTier()
    t0 = time.perf_counter()
    st = storage_histogram(keys_h[:n_storage], values_h[:n_storage], 8, tier,
                           vocab=vocab, spill=True, device=dev)
    storage_s = time.perf_counter() - t0
    check(torch.equal(st.counts, dev_res.counts),
          "storage_histogram != device_histogram")
    check(int(st.dropped) == 0, "storage_histogram dropped pairs")
    emit("storage_histogram", tokens=n_storage, ndev=8, wall_s=storage_s,
         shuffled_bytes=st.shuffled_bytes, buffer_bytes=st.buffer_bytes,
         spilled=st.spilled, equal=True)


# -- phase 4: the main path ------------------------------------------------------

def zipf_corpus(nbytes: int, vocab_size: int, seed: int, a: float) -> bytes:
    """Newline-separated lines of 16 words drawn with Zipf exponent ``a``
    over ``vocab_size`` hex words, the shortest the most frequent
    (leading bytes and lengths vary, so partitions spread)."""
    rng = np.random.default_rng(seed)
    vocab = np.array([f"{i:x}".encode() for i in range(vocab_size)], dtype=object)
    p = np.arange(1, vocab_size + 1, dtype=np.float64) ** -a
    p /= p.sum()
    words: list = []
    size = 0
    while size < nbytes:
        ids = rng.choice(vocab_size, 1 << 20, p=p)
        chunk = vocab[ids]
        lines = [b" ".join(chunk[i : i + 16]) for i in range(0, len(chunk), 16)]
        block = b"\n".join(lines) + b"\n"
        words.append(block)
        size += len(block)
    data = b"".join(words)[:nbytes]
    return data[: data.rfind(b"\n")]


def terasort_parts(n_records: int, n_parts: int, seed: int) -> list:
    """gensort-style ASCII records: a 10-byte printable key, then a row id
    and filler, 100 bytes with the newline."""
    rng = np.random.default_rng(seed)
    rec = np.full((n_records, 100), ord("A"), dtype=np.uint8)
    rec[:, :10] = rng.integers(32, 127, (n_records, 10), dtype=np.uint8)
    rec[:, 10:12] = ord(" ")
    rows = np.char.zfill(np.arange(n_records).astype(str), 32).astype("S32")
    rec[:, 12:44] = np.frombuffer(rows.tobytes(), np.uint8).reshape(-1, 32)
    rec[:, 44:46] = ord(" ")
    rec[:, 99] = ord("\n")
    per = n_records // n_parts
    return [rec[i * per : (i + 1) * per].tobytes() for i in range(n_parts)]


def _read_parts(store, path: str, n: int) -> list:
    return [
        store.read(f"{path}/part_{p:04d}")
        if store.exists(f"{path}/part_{p:04d}") else None
        for p in range(n)
    ]


def phase_main_path(dev, seed: int, corpus_bytes: int, n_records: int):
    from repro_torch.api import ClusterConfig, MarvelClient
    from repro_torch.core.mapreduce import wordcount_job
    from repro_torch.kernels import bucket_histogram as bh
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    # Zipf exponent 0.5 keeps every reduce within the engine's int32 rule
    # (max value x pairs < 2^31), so WordCount runs wholly on the device;
    # at 1.1, as in natural text, that rule sends every reduce to the host.
    corpus = zipf_corpus(corpus_bytes, 1 << 17, seed, a=0.5)
    natural = zipf_corpus(corpus_bytes, 1 << 17, seed + 1, a=1.1)
    parts = terasort_parts(n_records, 8, seed)
    emit("main_path_data", corpus_bytes=len(corpus), terasort_records=n_records,
         terasort_bytes=sum(map(len, parts)), setup_s=time.perf_counter() - t0,
         cut="WordCount corpus 64 MiB, not the paper's 1-15 GB: the host-side "
             "Python mapper must finish within the time limit")
    n_red = 4

    def wordcount(device: bool, capacity_factor: float = 1.3, data=corpus):
        cfg = ClusterConfig(tiers=("dram",), block_size=8 << 20, device=True,
                            device_capacity_factor=capacity_factor)
        with MarvelClient(cfg) as c:
            c.store.write("/in", data, record_delim=b"\n")
            t = time.perf_counter()
            h = c.mapreduce(wordcount_job(n_red), "/in", "/out", device=device)
            wall = time.perf_counter() - t
            return _read_parts(c.store, "/out", n_red), h.report, wall

    def terasort(device: bool):
        cfg = ClusterConfig(tiers=("dram",), block_size=8 << 20, device=True)
        with MarvelClient(cfg) as c:
            t = time.perf_counter()
            h = c.terasort("ts", parts, n_ranges=4, device=device)
            return h.result, h.report, time.perf_counter() - t

    # Keep the main path's largest partition input to time the kernel at
    # the shape the path gives it (the spy counts nothing itself).
    largest = {}
    real_partition_counts = ops.partition_counts

    def spy(dest, n_parts):
        if dest.numel() > largest.get("n", -1):
            largest.update(n=dest.numel(), dest=dest.clone(), n_parts=n_parts)
        return real_partition_counts(dest, n_parts)

    ops.partition_counts = spy
    bh.launches = 0  # the main path starts here
    try:
        wc_dev, wc_rep, wc_s = wordcount(device=True)
        ts_dev, ts_rep, ts_s = terasort(device=True)
        sp_dev, sp_rep, sp_s = wordcount(device=True, capacity_factor=0.05)
        nat_dev, nat_rep, nat_s = wordcount(device=True, data=natural)
    finally:
        ops.partition_counts = real_partition_counts
    launches = bh.launches  # ... and ends here
    wc_host, _, wc_host_s = wordcount(device=False)
    ts_host, _, ts_host_s = terasort(device=False)
    nat_host, _, nat_host_s = wordcount(device=False, data=natural)

    ex = wc_rep.extra
    check(wc_dev == wc_host and any(wc_dev), "WordCount device != host bytes")
    check(ex["device_pairs"] > 0, "WordCount partitioned nothing on the device")
    check(ex["device_fallback_tasks"] == 0, "WordCount reduce fell back to host")
    check(ts_dev == ts_host and len(ts_dev) == n_records,
          "TeraSort device != host records")
    check(ts_dev == sorted(ts_dev), "TeraSort output is not sorted")
    check(sp_dev == wc_host, "spilled WordCount device != host bytes")
    check(sp_rep.extra["device_spilled_pairs"] > 0, "spill path did not run")
    check(nat_dev == nat_host and any(nat_dev),
          "Zipf(1.1) WordCount device != host bytes")
    map_tasks = sum(r.tasks - n_red for r in (wc_rep, sp_rep, nat_rep))
    scatters = ts_rep.extra["device_tasks"]
    check(launches >= map_tasks + scatters,
          f"bucket_histogram launched {launches} times for {map_tasks} map "
          f"and {scatters} scatter tasks")
    emit("wordcount", bytes=len(corpus), device_s=wc_s, host_s=wc_host_s,
         tasks=wc_rep.tasks, device_pairs=ex["device_pairs"],
         device_groups=ex["device_groups"], identical=True)
    emit("terasort", records=n_records, device_s=ts_s, host_s=ts_host_s,
         scatter_tasks=scatters, identical=True)
    emit("wordcount_spill", capacity_factor=0.05, device_s=sp_s,
         spilled_pairs=sp_rep.extra["device_spilled_pairs"], identical=True)
    emit("wordcount_zipf1.1", bytes=len(natural), device_s=nat_s,
         host_s=nat_host_s, device_pairs=nat_rep.extra["device_pairs"],
         device_fallback_tasks=nat_rep.extra["device_fallback_tasks"],
         identical=True)
    emit("main_path_launches", bucket_histogram=launches,
         map_and_scatter_tasks=map_tasks + scatters)
    return launches, largest


# -- phase 6: the attention kernels against their plain versions -------------

#: tolerance of a kernel against its plain version run in f32, by input
#: type (the reference's own kernel tests: tests/test_kernels.py:42).
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}


class AttnRecord:
    """Checks of one attention kernel: its largest error against the plain
    version run in f32, and the number of cases checked."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.max_abs_err = 0.0
        self.checks = 0

    def compare(self, case: str, got: torch.Tensor, want: torch.Tensor,
                dtype: torch.dtype) -> float:
        check(got.shape == want.shape, f"{self.name} {case}: shape "
              f"{tuple(got.shape)} != {tuple(want.shape)}")
        check(bool(torch.isfinite(got.float()).all()),
              f"{self.name} {case}: non-finite output")
        err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
        tol = ATTN_TOL[dtype]
        check(err <= tol, f"{self.name} {case}: max abs err {err} > {tol}")
        self.max_abs_err = max(self.max_abs_err, err)
        self.checks += 1
        return err


def _randn(g, shape, dtype, dev):
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def flash_inputs(g, dev, B, T, H, Kv, dh, dtype, Tk=None):
    Tk = T if Tk is None else Tk
    return (_randn(g, (B, T, H, dh), dtype, dev),
            _randn(g, (B, Tk, Kv, dh), dtype, dev),
            _randn(g, (B, Tk, Kv, dh), dtype, dev))


#: the flash kernel's route by input type: tensor cores for bf16/f16
FLASH_ROUTE = {torch.bfloat16: "wgmma", torch.float16: "wgmma",
               torch.float32: "f32"}


def flash_case(rec: AttnRecord, case: str, q, k, v, **kw) -> None:
    """The kernel against its plain version run in f32, on the route its
    input type must take, and twice: the same bytes both times."""
    from repro_torch.kernels import flash_attention as fa

    route = fa._plan(q, k, v).route
    check(route == FLASH_ROUTE[q.dtype],
          f"flash_attention {case}: {q.dtype} took route {route}")
    got = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_torch(q.float(), k.float(), v.float(), **kw)
    err = rec.compare(case, got, want, q.dtype)
    check(torch.equal(got, again),
          f"flash_attention {case}: two calls on the same inputs differ")
    emit("flash_edge", case=case, route=route, shape=list(q.shape),
         kv_len=k.shape[1], kv_heads=k.shape[2], dtype=str(q.dtype),
         max_abs_err=err, repeatable=True, ok=True,
         **{k_: v_ for k_, v_ in kw.items() if v_ is not None})


def decode_case(rec: AttnRecord, case: str, q, kc, vc, lengths,
                **kw) -> float:
    from repro_torch.kernels import decode_attention as da

    got = da.decode_attention(q, kc, vc, lengths, **kw)
    want = da.decode_attention_torch(q.float(), kc.float(), vc.float(),
                                     lengths, **kw)
    return rec.compare(case, got, want, q.dtype)


def phase_attention_kernels(dev, seed: int, flash: AttnRecord,
                            decode: AttnRecord, T: int, S: int) -> None:
    """Each attention kernel against its plain version on the card: the
    serving path's shape, then the edge cases of the contract."""
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    bf = torch.bfloat16
    H, Kv, dh = 16, 2, 128  # qwen2.5-3b's attention
    flash_case(flash, "path_causal", *flash_inputs(g, dev, 1, T, H, Kv, dh, bf))
    short = T // 2
    for case, (B, t, h, kv, d, dt), kw in (
        ("ragged_T", (2, short - 37, H, Kv, dh, bf), {}),
        ("T=1", (1, 1, H, Kv, dh, bf), {}),
        ("softcap", (1, short, H, Kv, dh, bf), {"softcap": 50.0}),
        ("dh64", (2, short - 5, 8, 2, 64, bf), {}),
        ("dh256_mqa", (1, short + 3, 8, 1, 256, bf), {}),
        ("dh256_window", (1, short - 9, 8, 2, 256, bf), {"window": 70}),
        ("mha", (1, short, H, H, dh, bf), {}),
        ("non_causal", (2, short - 11, H, Kv, dh, bf), {"causal": False}),
        ("window", (1, short + 50, H, Kv, dh, bf), {"window": 96}),
        ("float32", (1, short - 1, H, Kv, dh, torch.float32), {}),
        ("float16", (1, short, H, Kv, dh, torch.float16),
         {"softcap": 30.0, "scale": 0.1}),
    ):
        flash_case(flash, case, *flash_inputs(g, dev, B, t, h, kv, d, dt), **kw)
    # the edges of the 64-row q and 64-key kv tiles
    for t in (63, 64, 65, 127, 129):
        for kw in ({}, {"window": 50}):
            name = f"T={t}" + ("_window" if kw else "_causal")
            flash_case(flash, name, *flash_inputs(g, dev, 2, t, H, Kv, dh, bf),
                       **kw)
    # fewer and more queries than keys (rows aligned at the start, as the
    # reference's kernel does)
    for case, (t, tk), kw in (("Tq<Tk", (200, 333), {}),
                              ("Tq>Tk", (333, 200), {}),
                              ("Tq<Tk_non_causal", (77, 300), {"causal": False})):
        flash_case(flash, case,
                   *flash_inputs(g, dev, 1, t, H, Kv, dh, bf, Tk=tk), **kw)
    # TMA's rules: a head stride of 68 elements (136 bytes) must raise
    from repro_torch.kernels import flash_attention as fa

    q, k, v = flash_inputs(g, dev, 1, 64, H, Kv, dh, bf)
    wide = torch.empty(1, 64, H, dh + 4, dtype=bf, device=dev)[..., :dh]
    try:
        fa.flash_attention(wide, k, v)
    except ValueError as exc:
        emit("flash_edge", case="misaligned_view", raised="ValueError",
             message=str(exc)[:120], ok=True)
    else:
        raise SmokeError("flash_attention took a view TMA cannot load")

    # decode: every length from 1 to S at the serving path's shape
    q = _randn(g, (1, H, dh), bf, dev)
    kc = _randn(g, (1, S, Kv, dh), bf, dev)
    vc = _randn(g, (1, S, Kv, dh), bf, dev)
    worst = 0.0
    for n in range(1, S + 1):
        lengths = torch.full((1,), n, dtype=torch.int32, device=dev)
        worst = max(worst, decode_case(decode, f"length={n}", q, kc, vc, lengths))
    emit("decode_edge", case="every_length", S=S, lengths=[1, S],
         max_abs_err=worst, ok=True)
    lengths8 = torch.tensor([1, 2, 31, 32, 33, S // 2, S - 1, S],
                            dtype=torch.int32, device=dev)
    for case, (B, h, kv, d, dt), lens, kw in (
        ("rep8_batch8_mixed", (8, H, Kv, dh, bf), lengths8, {}),
        ("rep1_mha", (2, H, H, dh, bf), None, {}),
        ("dh256_mqa", (2, 8, 1, 256, bf), None, {}),
        ("dh64", (2, 8, 2, 64, bf), None, {}),
        ("softcap", (8, H, Kv, dh, bf), lengths8, {"softcap": 50.0}),
        ("float32", (2, H, Kv, dh, torch.float32), None, {}),
    ):
        q = _randn(g, (B, h, d), dt, dev)
        kc = _randn(g, (B, S, kv, d), dt, dev)
        vc = _randn(g, (B, S, kv, d), dt, dev)
        if lens is None:
            lens = torch.tensor([S // 3, S][:B], dtype=torch.int32, device=dev)
        err = decode_case(decode, case, q, kc, vc, lens, **kw)
        emit("decode_edge", case=case, B=B, S=S, heads=h, kv_heads=kv, dh=d,
             dtype=str(dt), max_abs_err=err, ok=True, **kw)
    # lengths[b] == 0 gives zeros (the TPU kernel's definition)
    from repro_torch.kernels import decode_attention as da

    zero = torch.tensor([0, S], dtype=torch.int32, device=dev)
    q = _randn(g, (2, H, dh), bf, dev)
    kc = _randn(g, (2, S, Kv, dh), bf, dev)
    vc = _randn(g, (2, S, Kv, dh), bf, dev)
    out = da.decode_attention(q, kc, vc, zero)
    check(bool((out[0] == 0).all()), "decode: lengths == 0 must give zeros")
    decode_case(decode, "zero_length", q, kc, vc, zero)
    emit("decode_edge", case="zero_length", ok=True)
    decode_graph_case(dev, g, S)


def decode_graph_case(dev, g, S: int) -> None:
    """Decode captured alone in a CUDA graph and replayed with new lengths
    (written into the captured tensor) gives the bytes of the eager call:
    a call queries, allocates and synchronises nothing that capture would
    freeze or refuse, and reads lengths on the device."""
    from repro_torch.kernels import decode_attention as da

    bf = torch.bfloat16
    q = _randn(g, (1, 16, 128), bf, dev)
    kc = _randn(g, (1, S, 2, 128), bf, dev)
    vc = _randn(g, (1, S, 2, 128), bf, dev)
    lengths = torch.full((1,), S // 2, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # warm up off the capture
        da.decode_attention(q, kc, vc, lengths)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.decode_attention(q, kc, vc, lengths)
    replayed = []
    for n in (1, 17, S // 3, S - 1, S):
        lengths.fill_(n)
        graph.replay()
        eager = da.decode_attention(
            q, kc, vc, torch.full((1,), n, dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        check(torch.equal(out, eager),
              f"decode_attention: the graph replayed at length {n} gives "
              "other bytes than the eager call")
        replayed.append(n)
    emit("decode_edge", case="cuda_graph_replay", lengths=replayed,
         matches_eager=True, ok=True)


#: the profiler's names of a kernel launch on the host (a cluster launch
#: through cudaLaunchKernelEx shows as cudaLaunchKernelExC)
LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernelEx", "cuLaunchKernel",
               "cudaLaunchKernelExC")


#: the profiler's names of the host calls that start a device operation
OP_KEYS = LAUNCH_KEYS + ("cudaMemsetAsync", "cudaMemcpyAsync")
#: runtime queries and settings that a prepared call must not repeat
QUERY_KEYS = ("cudaDeviceGetAttribute", "cudaFuncSetAttribute",
              "cudaOccupancy", "cudaGetDeviceProperties")


def profile_window(fn, reps: int = REPS):
    """One profiler window over ``reps`` calls of ``fn`` after a warm-up:
    its events, its device records and their device time in us.  The
    device trace of a window now and then comes back empty: take the first
    of three windows that has one."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in kernels)
        if total > 0:
            break
    check(total > 0, "the profiler saw no device time")
    return events, kernels, total


def device_profile(fn, reps: int = REPS, op_keys=LAUNCH_KEYS):
    """Device time of one call of ``fn`` in ms, the device operations one
    call starts (kernel launches, or the host calls in ``op_keys``), and
    the names of the device records it ran: one profiler window over
    ``reps`` calls, without the host time that an event pair around each
    call also holds.  The trace can miss some kernel records of a window
    (seen for the SSD kernel: 7 of 15), so where it holds fewer kernel
    records than host launches the time is scaled up by their ratio."""
    events, kernels, total = profile_window(fn, reps)
    launches = sum(e.count for e in events if e.key in LAUNCH_KEYS)
    records = sum(e.count for e in kernels if "memset" not in e.key.lower())
    missed = max(1.0, launches / records) if records else 1.0
    ops = sum(e.count for e in events if e.key in op_keys)
    return (total * missed / reps / 1e3, ops / reps,
            {e.key for e in kernels})


def device_ms(fn, reps: int = REPS) -> float:
    """Device time of one call of ``fn`` in ms (see device_profile)."""
    return device_profile(fn, reps)[0]


def measure_flash(q, k, v, kw) -> dict:
    """Kernel, plain-version and SDPA times at the path's shape (event-timed
    around each call, so with the wrapper's host time; and the device time
    alone from the profiler), and the bound: the larger of the causal
    operations over the bf16 peak and the bytes over the memory rate."""
    from repro_torch.kernels import flash_attention as fa

    B, T, H, dh = q.shape
    Tk = k.shape[1]
    causal = kw.get("causal", True)
    flash = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    kernel_ms = time_ms(flash)
    library_ms = time_ms(sdpa)
    plain_ms = time_ms(lambda: fa.flash_attention_torch(q, k, v, **kw), reps=5)
    pairs = sum(min(i + 1, Tk) for i in range(T)) if causal else T * Tk
    flops = 4 * B * H * dh * pairs
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    ops_ms = flops / BF16_FLOPS * 1e3
    bytes_ms = bytes_bound_ms(nbytes)
    return {
        "shape": {"B": B, "T": T, "H": H, "Kv": k.shape[2], "dh": dh,
                  "causal": causal, "dtype": str(q.dtype)},
        "kernel_route": fa._plan(q, k, v).route,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "device_ms": device_ms(flash), "library_device_ms": device_ms(sdpa),
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "flops": flops, "bytes": nbytes,
    }


def measure_decode(q, kc, vc, lengths) -> dict:
    """Kernel, plain-version and masked-SDPA times at the path's shape
    (event-timed around each call, so with the wrapper's host time; and
    the device time alone from the profiler, with the device kernels one
    call runs, which must be one), and the bound: q, the cache rows up to
    ``lengths`` and the output, over the memory rate."""
    from repro_torch.kernels import decode_attention as da

    B, H, dh = q.shape
    S, Kv = kc.shape[1], kc.shape[2]
    decode = lambda: da.decode_attention(q, kc, vc, lengths)  # noqa: E731
    kernel_ms = time_ms(decode)
    plain_ms = time_ms(lambda: da.decode_attention_torch(q, kc, vc, lengths))
    qt = q[:, :, None, :]
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    library_ms = time_ms(sdpa)
    plan = da._plan(B, S, H, Kv, q.dtype, da._sm_count(q.get_device()))
    dev_ms, per_call, names = device_profile(decode)
    check(per_call == 1 and all("decode_mma_kernel" in n for n in names),
          f"decode_attention made {per_call} launches a call, of {names}: "
          "want one of its own kernel")
    rows = int(lengths.clamp(0, S).sum())
    nbytes = q.element_size() * (2 * q.numel() + 2 * rows * Kv * dh) + 4 * B
    return {
        "shape": {"B": B, "H": H, "Kv": Kv, "dh": dh, "S": S,
                  "lengths": lengths.tolist(), "dtype": str(q.dtype)},
        "kernel_route": plan.route,
        "plan": {"n_splits": plan.n_splits, "split_len": plan.split_len,
                 "heads": plan.heads, "groups": plan.groups},
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "device_ms": dev_ms, "library_device_ms": device_ms(sdpa),
        "launches_per_call": per_call,
        "bound_ms": bytes_bound_ms(nbytes), "bound_by": "bytes",
        "bytes": nbytes,
    }


# -- phase 7: serving at full qwen2.5-3b width -------------------------------

def _blobs(pool, conversation: str) -> dict:
    """A conversation's block blobs and meta record, by key suffix."""
    prefix = pool.pager.session_prefix(pool._scoped(conversation))
    store = pool.pager.store
    return {key[len(prefix):]: store.get(key) for key in sorted(store.keys(prefix))}


def _tok(fut) -> int:
    return int(fut.result().reshape(-1)[0])


class _Spy:
    """Wraps a module attribute while installed: counts its calls, keeps
    the last call's arguments and adds up its wall seconds, synchronising
    the card first when ``timed`` (the kernels' own counts stay the
    launch counts)."""

    def __init__(self, module, name: str, timed: bool = False) -> None:
        self.module, self.name, self.timed = module, name, timed
        self.real = getattr(module, name)
        self.calls = 0
        self.seconds = 0.0
        self.last = None
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        t = time.perf_counter()
        out = self.real(*args, **kwargs)
        if self.timed:
            torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t
        self.calls += 1
        self.last = (args, kwargs)
        return out

    def restore(self) -> None:
        setattr(self.module, self.name, self.real)


def draw_params(cfg, seed: int, dev):
    """Random bf16 weights for ``cfg``, drawn on the card from ``seed``
    with the model's own init, then with the attention projections scaled
    to their true fan-in.

    The shared init rule (``ParamDef.fan_in_scale``, as in the reference
    package) reads ``shape[-2]`` as the fan-in, which for the 3-D
    projections ``wq``/``wk``/``wv`` (D, heads, dh) is the head count and
    for ``wo`` (H, dh, D) is dh.  At full width that makes q and k a few
    hundred times too large: every softmax saturates to a hard argmax, and
    a perturbation of one rounding flips which key wins, so decode and
    prefill give uncorrelated logits over 36 layers however exact the
    kernels (the serving phase prints that error, with the model's own
    init, beside the checked one).  Scaling by the true fan-in (D for
    q/k/v, H*dh for o) gives a model as well conditioned as a trained one,
    on which decode and prefill can be held against each other.
    """
    from repro_torch.models import init_params, model_defs

    params = init_params(model_defs(cfg), torch.Generator(device=dev).manual_seed(seed), dev)
    D, H, Kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    fix = {"wq": (H / D) ** 0.5, "wk": (Kv / D) ** 0.5, "wv": (Kv / D) ** 0.5,
           "wo": (dh / (H * dh)) ** 0.5}
    for block in [*params["prelude"], *params["body"], *params["postlude"]]:
        for name, factor in fix.items():
            block["mixer"][name].mul_(factor)
    return params


def phase_serving(dev, seed: int, cfg, prompt_len: int, max_tokens: int,
                  n_convs: int, int8_steps: int, lossless_steps: int,
                  workdir: Path):
    """Marvel-Serve through ``MarvelClient.serving`` on the card: int8
    demotion under warm-pool pressure, lossless suspend/resume byte
    identity, a restart that re-adopts sessions from PMEM, and the
    prefill/decode consistency check, then a profile of the bare model
    step.  Returns the kernels' launch counts on the path, the arguments
    of the last flash and decode calls on it, the weights, and the hot
    steps per second one invoker sustained in the lossless pool."""
    from repro_torch.api import ClusterConfig, MarvelClient, ServingConfig, TierSpec
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import attention, init_params, model_defs
    from repro_torch.models.quant_cache import QuantAttnCache

    t0 = time.perf_counter()
    params = draw_params(cfg, seed, dev)
    n_params = sum(p.numel() for p in _leaves(params))
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (n_convs, 1, prompt_len), dtype=np.int32)
    torch.cuda.synchronize()
    emit("serving_setup", model=cfg.name, params=n_params,
         param_bytes=sum(p.numel() * p.element_size() for p in _leaves(params)),
         layers=cfg.n_layers, d_model=cfg.d_model, prompt_len=prompt_len,
         max_tokens=max_tokens, conversations=n_convs,
         setup_s=time.perf_counter() - t0)

    def cluster(name: str, lossless: bool, warm_pool: int) -> ClusterConfig:
        root = workdir / name
        return ClusterConfig(
            name=name,
            tiers=(TierSpec("dram"), TierSpec("pmem", path=str(root / "pmem"))),
            invokers=1, warm_pool=warm_pool, commit_every=1,
            journal="pmem", journal_path=str(root / "journal"),
            serving=ServingConfig(block_tokens=16, lossless=lossless),
        )

    def serve(client):
        return client.serving(params, cfg, prompt_len=prompt_len,
                              max_tokens=max_tokens, device=dev)

    flash_spy = _Spy(ops, "flash_attention")
    decode_spy = _Spy(ops, "decode_attention")
    quant_spy = _Spy(attention, "quant_decode_attention")
    counts = {}

    def mark(at: str) -> None:
        counts[at] = {"flash_attention": fa.launches,
                      "decode_attention": da.launches,
                      "quant_decode_attention": quant_spy.calls}

    fa.launches = da.launches = 0  # the serving path starts here
    try:
        # (a) int8 pool: more conversations than warm slots, steps
        # interleaved, so every eviction demotes to int8 and every resume
        # decodes through quant_decode_attention.
        with MarvelClient(cluster("int8", lossless=False, warm_pool=4)) as client:
            pool = serve(client)
            convs = [f"c{i}" for i in range(n_convs)]
            torch.cuda.synchronize()
            t = time.perf_counter()
            firsts = [_tok(pool.start(c, prompts[i])) for i, c in enumerate(convs)]
            prefill_s = time.perf_counter() - t
            mark("int8_prefilled")
            t = time.perf_counter()
            streams = {c: [] for c in convs}
            for _ in range(int8_steps):
                for c in convs:
                    streams[c].append(_tok(pool.step(c)))
            torch.cuda.synchronize()
            int8_s = time.perf_counter() - t
            stats = pool.stats()
            sid = pool._scoped(convs[0])
            layers, _ = pool.pager.load(sid)
        mark("int8_done")
        check(stats["demotions"] > 0 and stats["quantized_blocks"] > 0,
              f"no int8 demotion under warm-pool pressure: {stats}")
        check(isinstance(layers[0], QuantAttnCache)
              and layers[0].k_q.device == dev,
              "a demoted session did not come back as an int8 cache on the card")
        check(counts["int8_done"]["quant_decode_attention"] > 0,
              "no decode step ran on the int8 cache")
        toks = [x for c in convs for x in streams[c]] + firsts
        check(all(0 <= x < cfg.vocab for x in toks), "token out of vocabulary")
        emit("serving_int8", conversations=n_convs, steps_each=int8_steps,
             prefill_s=prefill_s, prefill_tokens_per_s=n_convs * prompt_len / prefill_s,
             decode_s=int8_s, tokens_per_s=n_convs * int8_steps / int8_s,
             demotions=stats["demotions"], resumes=stats["resumes"],
             demand_faults=stats["demand_faults"],
             quantized_blocks=stats["quantized_blocks"],
             int8_decode_calls=counts["int8_done"]["quant_decode_attention"])

        # (b) lossless suspend/resume and (c) a restart
        stream_c, hot_rate = lossless_and_restart(
            cluster("lossless", lossless=True, warm_pool=8), serve, prompts,
            firsts, lossless_steps, mark, "serving", dev)
    finally:
        for spy in (flash_spy, decode_spy, quant_spy):
            spy.restore()
    launches = dict(counts["after_restart"])  # ... and ends here
    check(counts["int8_done"]["flash_attention"] > 0,
          "flash_attention did not launch in the int8 pool's prefills")
    for kernel in ("flash_attention", "decode_attention"):
        check(counts["after_resume"][kernel] > counts["resumed"][kernel],
              f"{kernel} did not launch after the resume")
        check(counts["after_restart"][kernel] > counts["after_resume"][kernel],
              f"{kernel} did not launch after the restart")
    emit("serving_launches", **{k: v for k, v in counts.items()})

    # (d) consistency at full width: decode-step logits at position t
    # against a fresh prefill over the same tokens (holds the two kernels
    # against each other).
    tokens = torch.tensor([prompts[0, 0].tolist() + stream_c[:max_tokens]],
                          dtype=torch.int32, device=dev)
    rel, agree, n_dec = decode_vs_prefill(params, cfg, tokens, prompt_len,
                                          max_tokens)
    check(rel <= 2e-2, f"decode vs prefill logits: relative L2 error {rel} > 2e-2")
    # the same with the model's own init (reported, not held to the limit:
    # see draw_params)
    own = init_params(model_defs(cfg), torch.Generator(device=dev).manual_seed(seed), dev)
    own_rel, own_agree, _ = decode_vs_prefill(own, cfg, tokens, prompt_len,
                                              max_tokens)
    del own
    emit("serving_consistency", positions=n_dec, max_rel_l2=rel,
         argmax_agreement=agree, tolerance=2e-2,
         own_init_max_rel_l2=own_rel, own_init_argmax_agreement=own_agree)
    emit("serving_profile", **profile_decode(params, cfg, tokens, prompt_len,
                                             max_tokens))
    return launches, flash_spy.last, decode_spy.last, params, hot_rate


def lossless_and_restart(config, serve, prompts, firsts, lossless_steps: int,
                         mark, label: str, dev):
    """(b) and (c) of a serving phase.  In a lossless pool over
    ``config``, "b" is suspended to PMEM and resumed midway and "a" never
    is: both must decode the same tokens and leave byte-identical blobs;
    "c" runs ahead on the same prompt, timed per step (``decode_step``,
    ``KVPager.load``, ``KVPager.write``).  Then a fresh client over the
    same durable ``config`` re-adopts the three sessions and decodes on
    exactly.  ``serve(client)`` builds the pool; ``mark`` is called at
    "resumed", "after_resume" and "after_restart".  Returns "c"'s
    tokens and the hot steps per second of "a" and "b"."""
    from repro_torch.api import MarvelClient
    from repro_torch.serving import decode_runtime

    half = lossless_steps // 2
    with MarvelClient(config) as client:
        pool = serve(client)
        stream = {c: [_tok(pool.start(c, prompts[0]))] for c in ("a", "b")}
        for c in ("a", "b"):
            for _ in range(half):
                stream[c].append(_tok(pool.step(c)))
        check(pool.suspend("b") and not pool.is_resident("b"),
              "suspend did not demote the conversation")
        check(pool.resume("b"), "resume refused")
        mark("resumed")
        stream["c"] = [_tok(pool.start("c", prompts[0]))]
        timers = [_Spy(decode_runtime, "decode_step", timed=True),
                  _Spy(pool.pager, "load", timed=True),
                  _Spy(pool.pager, "write", timed=True)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            for c in ("a", "b"):
                for _ in range(lossless_steps - half):
                    stream[c].append(_tok(pool.step(c)))
            torch.cuda.synchronize()
            hot_s = time.perf_counter() - t
        finally:
            for timer in timers:
                timer.restore()
        hot_steps = 2 * (lossless_steps - half)
        breakdown = {f"{timer.name}_ms_per_step":
                     timer.seconds / hot_steps * 1e3 for timer in timers}
        mark("after_resume")
        layers, _ = pool.pager.load(pool._scoped("b"))
        check(all(x.device == dev for x in _leaves(layers)),
              "a resumed session decodes on host tensors")
        for _ in range(lossless_steps + 4):
            stream["c"].append(_tok(pool.step("c")))
        check(stream["a"] == stream["b"],
              f"lossless suspend/resume changed the tokens: "
              f"{stream['a']} vs {stream['b']}")
        check(stream["c"][:len(stream["a"])] == stream["a"],
              "the same prompt decoded to different tokens")
        blobs_a, blobs_b = _blobs(pool, "a"), _blobs(pool, "b")
        check(blobs_a.keys() == blobs_b.keys() and blobs_a == blobs_b,
              "lossless paging is not byte-identical")
        client.runtime.commit_all()
        pool.pager.sync()
    emit(f"{label}_lossless", steps=lossless_steps, suspended_at=half,
         identical_tokens=True, identical_blobs=True, blobs=len(blobs_a),
         blob_bytes=sum(map(len, blobs_a.values())),
         hot_decode_s=hot_s, hot_tokens_per_s=hot_steps / hot_s,
         step_ms=hot_s / hot_steps * 1e3, **breakdown)

    # (c) restart: a fresh client over the same durable config
    with MarvelClient(config) as client:
        pool = serve(client)
        adopted = pool.pager.recover()
        check(adopted == 3, f"restart re-adopted {adopted} of 3 sessions")
        resumed = [_tok(pool.step("a")) for _ in range(4)]
        want = stream["c"][len(stream["a"]):len(stream["a"]) + 4]
        check(resumed == want, f"after the restart 'a' decoded {resumed}, "
              f"the uninterrupted run {want}")
        fresh = _tok(pool.start("d", prompts[1]))
        check(fresh == firsts[1], "a new conversation after the restart "
              "did not reproduce the first token of the same prompt")
        mark("after_restart")
    emit(f"{label}_restart", adopted=adopted, continued=resumed, matches=True)
    return stream["c"], hot_steps / hot_s


@torch.no_grad()
def decode_vs_prefill(params, cfg, tokens, prompt_len: int, max_tokens: int):
    """Teacher-forced decode-step logits after a prefill of ``prompt_len``
    tokens, against one prefill over all of them: the largest relative L2
    error over the positions, the share of positions whose argmax agrees,
    and the number of positions."""
    from repro_torch.models import decode_step, forward, logits_fn

    n_dec = min(max_tokens, tokens.shape[1] - prompt_len)
    h, _, cache = forward(params, cfg, {"tokens": tokens[:, :prompt_len]},
                          collect_cache=True, cache_len=prompt_len + max_tokens)
    dec = [logits_fn(params, cfg, h[:, -1])]
    for t in range(prompt_len, prompt_len + n_dec - 1):
        lg, cache = decode_step(params, cfg, tokens[:, t:t + 1], cache, t)
        dec.append(lg)
    full, _ = forward(params, cfg, {"tokens": tokens[:, :prompt_len + n_dec - 1]})
    ref = logits_fn(params, cfg, full[0, prompt_len - 1:])
    dec = torch.cat(dec)
    check(bool(torch.isfinite(dec).all()), "non-finite decode logits")
    rel = ((dec - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()
    agree = float((dec.argmax(-1) == ref.argmax(-1)).float().mean())
    return rel, agree, n_dec


@torch.no_grad()
def profile_decode(params, cfg, tokens, prompt_len: int, max_tokens: int,
                   steps: int = 8) -> dict:
    """Where a bare model step's time goes: a prefill ``forward`` and hot
    ``decode_step`` wall times (host clock, synchronised), then one
    profiler window over ``steps`` decode steps for the device time and
    kernel launches per step."""
    from repro_torch.models import decode_step, forward

    def prefill():
        return forward(params, cfg, {"tokens": tokens[:, :prompt_len]},
                       collect_cache=True, cache_len=prompt_len + max_tokens)

    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, cache = prefill()
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1e3)
    # one profiler window over a prefill: its device time, and the flash
    # kernel's share of it
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prefill()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    prefill_device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    flash = [e for e in kernels if "flash_wgmma_kernel" in e.key
             or "flash_f32_kernel" in e.key]
    ssd = [e for e in kernels if "ssd_chunk_kernel" in e.key]
    step_ms = []
    for t in range(prompt_len, prompt_len + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_step(params, cfg, tokens[:, t:t + 1], cache, t)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    with torch.profiler.profile(activities=acts) as prof:
        for t in range(prompt_len, prompt_len + steps):
            decode_step(params, cfg, tokens[:, t:t + 1], cache, t)
        torch.cuda.synchronize()
    events = prof.key_averages()
    # the kernels themselves (an operator's own entry repeats their time)
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    decode = [e for e in kernels if "decode_mma_kernel" in e.key
              or "decode_f32_kernel" in e.key]
    launches = sum(e.count for e in events if e.key in LAUNCH_KEYS)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "prefill_forward_ms": statistics.median(prefill_ms),
        "prefill_device_ms": prefill_device_ms,
        "flash_ms_per_prefill": sum(e.self_device_time_total for e in flash) / 1e3,
        "flash_launches_per_prefill": sum(e.count for e in flash),
        "ssd_chunk_ms_per_prefill": sum(e.self_device_time_total for e in ssd) / 1e3,
        "ssd_chunk_launches_per_prefill": sum(e.count for e in ssd),
        "decode_step_ms": statistics.median(step_ms),
        "device_ms_per_step":
            sum(e.self_device_time_total for e in kernels) / steps / 1e3,
        "launches_per_step": launches / steps,
        "decode_attention_kernels_per_step": sum(e.count for e in decode) / steps,
        "decode_attention_ms_per_step":
            sum(e.self_device_time_total for e in decode) / steps / 1e3,
        "top_kernels_ms_per_step": {
            e.key[:60]: e.self_device_time_total / steps / 1e3 for e in top},
    }


# -- phase 8: traced multi-tenant serving under the autoscaler --------------

TRACE_TENANTS = 3
TRACE_SESSIONS = 4  # conversations a tenant: 12 in all
TRACE_WARM_POOL = 4  # fewer warm slots than conversations: evictions demote
TRACE_SECONDS = 12.0
TRACE_SLO_MS = 1000.0
TRACE_WINDOW_S = 1.0


class Conversations:
    """The replay's ``submit`` over a serving pool: an arrival of ``(app,
    session)`` starts conversation ``app/session`` (its prompt drawn from
    the seed) on its first admitted arrival and steps it after that.
    Returns the pool's future and keeps each conversation's futures in
    order."""

    def __init__(self, pool, prompts: dict) -> None:
        self.pool, self.prompts = pool, prompts
        self.futures: dict = {}

    def submit(self, fn, app, session, block=True, timeout=None, **inputs):
        check(fn == self.pool.decoder.fn.name and not inputs,
              f"the trace asked for {fn}({inputs})")
        conv = f"{app}/{session}"
        if conv not in self.futures:
            fut = self.pool.start(conv, self.prompts[conv], block=block,
                                  timeout=timeout)
            self.futures[conv] = [fut]
        else:
            fut = self.pool.step(conv, block=block, timeout=timeout)
            self.futures[conv].append(fut)
        return fut


def _finite(x: float):
    return x if math.isfinite(x) else None


def phase_traced_serving(dev, seed: int, cfg, params, hot_tokens_per_s: float,
                         prompt_len: int, max_tokens: int, workdir: Path):
    """A seeded multi-tenant trace replayed at ``MarvelClient.serving``
    over phase 7's weights: 3 tenants of 4 conversations, a 4x burst on
    t0, the base rate half what one invoker sustained hot in phase 7.
    Cell ``fixed`` serves it with one invoker, cell ``auto`` under
    ``MarvelClient.autoscaler`` (1 to 4 invokers), both lossless over a
    warm pool smaller than the conversations, so decode steps run on
    several invoker threads at once beside evictions' demotions.  Every
    conversation must decode the tokens of a sequential pass.  Returns the
    flash and decode launches on the path."""
    from repro_torch.api import ClusterConfig, MarvelClient, ServingConfig, TierSpec
    from repro_torch.core.autoscale import PolicySpec
    from repro_torch.core.loadgen import (
        BurstSpec, OpSpec, TraceSpec, generate_trace, rate_at, replay,
    )
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    spec = TraceSpec(
        seed=seed, duration=TRACE_SECONDS, base_rate=hot_tokens_per_s / 2,
        tenants=TRACE_TENANTS, sessions_per_tenant=TRACE_SESSIONS,
        zipf_skew=0.8, amplitude=0.0,
        bursts=(BurstSpec(start=4.0, duration=3.0, factor=4.0, tenant="t0"),),
        ops=(OpSpec("decode"),),
    )
    trace = generate_trace(spec)
    arrivals = Counter(f"{a.tenant}/{a.session}" for a in trace)
    check(max(arrivals.values()) <= max_tokens,
          f"a conversation of the trace has more arrivals than its "
          f"{max_tokens}-token headroom: {arrivals}")
    rng = np.random.default_rng(seed + 1)
    prompts = {f"t{i}/s{j}": rng.integers(0, cfg.vocab, (1, prompt_len), dtype=np.int32)
               for i in range(TRACE_TENANTS) for j in range(TRACE_SESSIONS)}
    emit("traced_setup", one_invoker_hot_tokens_per_s=hot_tokens_per_s,
         base_rate=spec.base_rate, burst_rate=rate_at(spec, 5.0),
         arrivals=len(trace), conversations=len(arrivals),
         max_arrivals_per_conversation=max(arrivals.values()),
         arrivals_per_tenant=Counter(a.tenant for a in trace),
         warm_pool=TRACE_WARM_POOL, slo_ms=TRACE_SLO_MS, window_s=TRACE_WINDOW_S)

    def cluster(name: str) -> ClusterConfig:
        root = workdir / name
        return ClusterConfig(
            name=name,
            tiers=(TierSpec("dram"), TierSpec("pmem", path=str(root / "pmem"))),
            invokers=1, warm_pool=TRACE_WARM_POOL, commit_every=1,
            journal="pmem", journal_path=str(root / "journal"),
            serving=ServingConfig(block_tokens=16, lossless=True),
        )

    def serve(client):
        return client.serving(params, cfg, prompt_len=prompt_len,
                              max_tokens=max_tokens, device=dev)

    def cell(name: str, policy) -> dict:
        """Replay the trace at a fresh pool; returns each conversation's
        tokens."""
        with MarvelClient(cluster(name)) as client:
            pool = serve(client)
            auto = client.autoscaler(policy) if policy is not None else None
            adapter = Conversations(pool, prompts)
            torch.cuda.synchronize()
            before = (fa.launches, da.launches)
            cpu0 = time.process_time()
            res = replay(adapter.submit, trace, spec=spec, slo_ms=TRACE_SLO_MS,
                         window_s=TRACE_WINDOW_S, admission="shed",
                         tick=auto.maybe_tick if auto is not None else None,
                         drain_timeout=600.0)
            torch.cuda.synchronize()
            cpu_s = time.process_time() - cpu0  # every thread's host time
            flash_n, decode_n = fa.launches - before[0], da.launches - before[1]
            snap = client.gateway.load_snapshot()
            gstats = client.gateway.stats()
            busy_s = sum(inv.busy_seconds for inv in gstats.invokers)
            streams = {c: [_tok(f) for f in futs]
                       for c, futs in adapter.futures.items()}
            invokers_after = None
            if auto is not None:
                check(client.gateway.quiesce(timeout=60.0),
                      f"{name}: the gateway did not quiesce after the drain")
                for k in range(1, 9):  # idle control ticks, a second apart
                    auto.maybe_tick(res.wall_s + k)
                invokers_after = client.gateway.load_snapshot().invokers
            stats = pool.stats()
        check(res.offered == len(trace) and res.errors == 0,
              f"{name}: {res.errors} errors over {res.offered} of "
              f"{len(trace)} arrivals")
        for tenant, ts in sorted(res.tenants.items()):
            check(ts.offered == ts.completed + ts.shed + ts.errors,
                  f"{name}: tenant {tenant} offered {ts.offered}, completed "
                  f"{ts.completed}, shed {ts.shed}, errors {ts.errors}")
        check(flash_n == cfg.n_layers * len(streams),
              f"{name}: {flash_n} flash launches for {len(streams)} prefills "
              f"of {cfg.n_layers} layers")
        check(decode_n == cfg.n_layers * res.completed > 0,
              f"{name}: {decode_n} decode launches for {res.completed} "
              f"decode steps of {cfg.n_layers} layers")
        iso = res.isolation("t0")
        out = {
            "cell": name, "wall_s": res.wall_s, "offered": res.offered,
            "completed": res.completed, "shed": res.shed,
            "decode_tokens_per_s": res.completed / res.wall_s,
            "p99_ms": res.p99_ms(),
            "p99_ms_per_tenant": {t: res.p99_ms(t) for t in sorted(res.tenants)},
            "p99_under_slo_frac": res.p99_under_slo_frac(),
            "goodput_frac": res.goodput_frac(),
            "goodput_frac_per_tenant": {t: res.goodput_frac(t)
                                        for t in sorted(res.tenants)},
            "isolation_t0_ratio": _finite(iso.ratio),
            "isolation_t0_burst_p99_ms": iso.burst_p99_ms,
            "isolation_t0_calm_p99_ms": iso.calm_p99_ms,
            "scale_actions": auto.scale_actions if auto is not None else 0,
            "peak_invokers": auto.peak_invokers if auto is not None else 1,
            "invokers_after_idle": invokers_after,
            "kv_resident_sessions": snap.resident_sessions,
            "kv_paged_sessions": snap.paged_sessions,
            "demotions": stats["demotions"], "resumes": stats["resumes"],
            "demand_faults": stats["demand_faults"],
            "flash_launches": flash_n, "decode_launches": decode_n,
            # where the time went: invocations' summed service time (each
            # from dispatch to done, on its invoker), the lane wait before
            # dispatch, and the process's host CPU time (all threads)
            "invoker_busy_s": busy_s,
            "service_ms_per_invocation": busy_s / res.completed * 1e3,
            "lane_wait_p99_ms": gstats.lane_wait_p99_ms,
            "host_cpu_s": cpu_s, "host_cores_busy": cpu_s / res.wall_s,
        }
        if auto is not None:
            out["actions"] = [(a["t"], a["kind"], *a["invokers"])
                              for a in auto.actions]
        emit("traced_cell", **out)
        if auto is not None:
            kinds = [a["kind"] for a in auto.actions]
            check("scale_up" in kinds, f"{name}: no scale_up in {kinds}")
            check(auto.peak_invokers >= 2,
                  f"{name}: a peak of {auto.peak_invokers} invokers")
            check(invokers_after == policy.min_invokers,
                  f"{name}: {invokers_after} invokers after the drain and "
                  f"idle ticks, not min_invokers={policy.min_invokers}")
        return streams

    fa.launches = da.launches = 0  # the traced path starts here
    t0 = time.perf_counter()
    cells = {
        "fixed": cell("fixed", None),
        "auto": cell("auto", PolicySpec(
            min_invokers=1, max_invokers=4, target_per_invoker=2,
            down_cooldown_s=0.5, warm_pool_per_invoker=2)),
    }
    launches = {"flash_attention": fa.launches,
                "decode_attention": da.launches}  # ... and ends here
    replay_s = time.perf_counter() - t0

    # the sequential pass: each conversation alone in a fresh pool, to the
    # most steps either cell completed for it
    need = {c: max(len(streams.get(c, ())) for streams in cells.values())
            for c in prompts}
    t0 = time.perf_counter()
    with MarvelClient(cluster("sequential")) as client:
        pool = serve(client)
        alone = {}
        for c, n in need.items():
            if n:
                alone[c] = [_tok(pool.start(c, prompts[c]))]
                alone[c] += [_tok(pool.step(c)) for _ in range(n - 1)]
    sequential_s = time.perf_counter() - t0
    for name, streams in cells.items():
        for c, stream in streams.items():
            check(stream == alone[c][:len(stream)],
                  f"{name}: conversation {c} decoded {stream}, alone "
                  f"{alone[c][:len(stream)]}")
    emit("traced_identity", conversations=len(alone),
         tokens_checked={k: sum(map(len, streams.values()))
                         for k, streams in cells.items()},
         sequential_tokens=sum(map(len, alone.values())),
         identical=True, replay_s=replay_s, sequential_s=sequential_s)
    return launches


# -- phase 9: the SSD kernel against its plain version ----------------------

#: tolerance of the SSD kernel against its plain version, abs and rel: the
#: reference's own kernel test (tests/test_kernels.py:112-115).
SSD_TOL = 2e-3


class SSDRecord:
    """Checks of the SSD kernel: its largest error against the plain
    version, and the number of cases checked."""

    def __init__(self) -> None:
        self.max_abs_err = 0.0
        self.checks = 0

    def compare(self, case: str, args, oracle: bool = False) -> float:
        """Kernel against the plain version on ``args`` (and against the
        exp-then-mask oracle when ``oracle``), with two kernel runs
        compared bit for bit."""
        from repro_torch.kernels import ref, ssd_scan

        got = ssd_scan.ssd_chunk_fwd(*args)
        again = ssd_scan.ssd_chunk_fwd(*args)
        wants = [ssd_scan.ssd_chunk_torch(*args)]
        if oracle:
            wants.append(ref.ssd_chunk_ref(*args))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"ssd_chunk {case}: two runs on the same inputs differ")
        err = 0.0
        for want in wants:
            for name, g, w in zip(("y_diag", "states"), got, want):
                check(g.shape == w.shape and g.dtype == torch.float32,
                      f"ssd_chunk {case} {name}: {g.dtype} {tuple(g.shape)}, "
                      f"want {tuple(w.shape)}")
                check(bool(torch.isfinite(g).all()),
                      f"ssd_chunk {case} {name}: non-finite output")
                diff = (g - w).abs()
                if diff.numel():
                    worst = float((diff - SSD_TOL * w.abs()).max())
                    check(worst <= SSD_TOL, f"ssd_chunk {case} {name}: "
                          f"|err| - rtol*|want| = {worst} > {SSD_TOL}")
                    err = max(err, float(diff.max()))
        self.max_abs_err = max(self.max_abs_err, err)
        self.checks += 1
        return err


def ssd_inputs(g, dev, BC, Q, H, P, N, decay=0.1, shared=True):
    """x, dt, dA_cs, B, C as the reference's kernel test draws them (dA_cs a
    decreasing cumulative sum within the chunk); ``shared`` hands B and C
    over as one group read by every head (an expand view, head stride 0),
    as the model does."""
    x = torch.randn(BC, Q, H, P, generator=g, device=dev)
    dt = torch.rand(BC, Q, H, generator=g, device=dev)
    dA = -torch.cumsum(torch.rand(BC, Q, H, generator=g, device=dev) * decay, 1)
    heads = 1 if shared else H
    Bm = torch.randn(BC, Q, heads, N, generator=g, device=dev)
    Cm = torch.randn(BC, Q, heads, N, generator=g, device=dev)
    return x, dt, dA, Bm.expand(-1, -1, H, -1), Cm.expand(-1, -1, H, -1)


def phase_ssd_kernel(dev, seed: int, rec: SSDRecord) -> None:
    """The SSD kernel against its plain version on the card: the prefill's
    shape, then the edge cases of the contract."""
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    path = (4, 256, 80, 64, 128)  # a 1024-token mamba2-2.7b prefill
    args = ssd_inputs(g, dev, *path)
    err = rec.compare("path", args)
    emit("ssd_edge", case="path", shape=list(path), max_abs_err=err, ok=True)
    # the shared group read through a head stride of 0 gives the same bytes
    # as the same values copied per head
    from repro_torch.kernels import ssd_scan

    view = ssd_scan.ssd_chunk_fwd(*args)
    copied = ssd_scan.ssd_chunk_fwd(*args[:3], *(t.contiguous() for t in args[3:]))
    check(all(torch.equal(a, b) for a, b in zip(view, copied)),
          "ssd_chunk: a head-stride-0 B/C gives other bytes than its copy")
    emit("ssd_edge", case="stride0_equals_copy", ok=True)
    del args, view, copied
    for case, shape, kw in (
        ("per_head_BC", path, {"shared": False}),
        ("Q=1", (2, 1, 80, 64, 128), {}),
        ("Q=37", (3, 37, 80, 64, 128), {}),
        ("H=6", (2, 100, 6, 16, 16), {}),
        ("P16_N128", (2, 200, 5, 16, 128), {}),
        ("P32_N32", (2, 200, 5, 32, 32), {}),
        ("P128_N64", (2, 200, 5, 128, 64), {"shared": False}),
        ("P128_N128", (2, 256, 5, 128, 128), {}),
        ("P64_N16", (2, 130, 5, 64, 16), {}),
        # 13 heads: the last set of a y block (8) and a state block (4) is short
        ("H=13", (2, 256, 13, 64, 128), {}),
    ):
        err = rec.compare(case, ssd_inputs(g, dev, *shape, **kw))
        emit("ssd_edge", case=case, shape=list(shape), max_abs_err=err, ok=True,
             **kw)
    # dA_cs falling by up to 100 a row: the oracle's exp above the diagonal
    # overflows to inf before its mask, which the kernel never computes
    args = ssd_inputs(g, dev, 2, 256, 8, 64, 128, decay=100.0)
    da = args[2]
    check(bool(torch.isinf(torch.exp(da[:, :, None] - da[:, None])).any()),
          "the strongly negative case does not overflow exp")
    err = rec.compare("strongly_negative", args, oracle=True)
    emit("ssd_edge", case="strongly_negative", decay=100.0, max_abs_err=err,
         ok=True)


def measure_ssd(x, dt, dA_cs, Bm, Cm) -> dict:
    """Kernel and plain-version times at the path's shape (event-timed, and
    the device time alone from the profiler), and the bound: the larger of
    the bytes (each input read once, a stride-0 B/C once per chunk, the
    outputs written once) over the memory rate and the least operations
    (C.B^T once per chunk when every head reads one B/C group, the causal
    products of each head) over the TF32 peak.  No single PyTorch call
    computes this function, so there is no library time."""
    from repro_torch.kernels import ssd_scan

    BC, Q, H, P = x.shape
    N = Bm.shape[-1]
    ssd = lambda: ssd_scan.ssd_chunk_fwd(x, dt, dA_cs, Bm, Cm)  # noqa: E731
    kernel_ms = time_ms(ssd)
    plain_ms = time_ms(lambda: ssd_scan.ssd_chunk_torch(x, dt, dA_cs, Bm, Cm),
                       reps=5)
    dev_ms, per_call, names = device_profile(ssd)
    check(per_call == 1 and all("ssd_chunk_kernel" in n for n in names),
          f"ssd_chunk made {per_call} launches a call, of {names}")
    bc_heads = [1 if t.stride(2) == 0 else H for t in (Bm, Cm)]
    nbytes = 4 * (2 * x.numel() + 2 * dt.numel()
                  + sum(BC * Q * h * N for h in bc_heads) + BC * H * P * N)
    pairs = Q * (Q + 1) // 2
    cb_sets = 1 if bc_heads == [1, 1] else H  # C.B^T computed per set
    flops = BC * (cb_sets * 2 * pairs * N + H * (2 * pairs * P + 2 * Q * P * N))
    ops_ms = flops / TF32_FLOPS * 1e3
    bytes_ms = bytes_bound_ms(nbytes)
    plan = ssd_scan._plan(BC, Q, H, P, bc_heads == [1, 1])
    return {
        "shape": {"BC": BC, "Q": Q, "H": H, "P": P, "N": N,
                  "B_C_head_stride_0": bc_heads == [1, 1], "dtype": "float32"},
        "kernel_route": "3xTF32: C.B^T on mma.sync, y and states on wgmma",
        "plan": {"y_heads": plan.y_heads, "s_heads": plan.s_heads,
                 "blocks": plan.blocks},
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
        "device_ms": dev_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "flops": flops, "bytes": nbytes,
    }


# -- phase 10: serving Mamba-2 at full mamba2-2.7b width ----------------------

def draw_ssm_params(cfg, seed: int, dev):
    """Random bf16 weights for a Mamba-2 ``cfg``, drawn on the card from
    ``seed`` with the model's own init, then with the three leaves that
    init simplifies set as Mamba-2's published init sets them: ``dt_bias``
    so that softplus gives dt log-uniform in [0.001, 0.1], ``A_log`` as
    log U[1, 16], and the output projection ``wo`` divided by
    sqrt(n_layers) (the pre-norm residual rescaling).

    The model's own init (``dt_bias`` 0, ``A_log`` 0) gives dt near 0.7
    and one decay for every head, so the recurrent state forgets within
    a token or two and a state restored wrongly after a resume would
    barely change the tokens.  With the published dt and A most heads
    carry the state over tens to thousands of tokens, so the paging
    checks depend on it.
    """
    from repro_torch.models import init_params, model_defs

    g = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(model_defs(cfg), g, dev)
    for block in [*params["prelude"], *params["body"], *params["postlude"]]:
        mixer = block["mixer"]
        dt = torch.exp(torch.rand(mixer["dt_bias"].shape, generator=g, device=dev)
                       * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
        dt = dt.clamp_min(1e-4)
        mixer["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
        a = torch.rand(mixer["A_log"].shape, generator=g, device=dev) * 15 + 1
        mixer["A_log"].copy_(torch.log(a))
        mixer["wo"].mul_(1 / math.sqrt(cfg.n_layers))
    return params


def phase_ssm_serving(dev, seed: int, cfg, prompt_len: int, max_tokens: int,
                      n_convs: int, steps: int, lossless_steps: int,
                      workdir: Path):
    """Marvel-Serve over Mamba-2 through ``MarvelClient.serving`` on the
    card: conversations interleaved over a warm pool half their number
    (each eviction pushes a recurrent state to PMEM, each next step resumes
    one), lossless suspend/resume byte identity, a restart that re-adopts
    the sessions, and decode-step logits against a fresh prefill.  Returns
    the SSD kernel's launches on the path and the arguments of its last
    call there."""
    from repro_torch.api import ClusterConfig, MarvelClient, ServingConfig, TierSpec
    from repro_torch.kernels import ops, ssd_scan
    from repro_torch.models import init_params, model_defs

    t0 = time.perf_counter()
    params = draw_ssm_params(cfg, seed, dev)
    s = cfg.ssm
    H, P, N = s.n_heads(cfg.d_model), s.head_dim, s.d_state
    convdim = s.d_inner(cfg.d_model) + 2 * s.n_groups * N
    state_bytes = cfg.n_periods * H * P * N * 4
    conv_bytes = cfg.n_periods * (s.d_conv - 1) * convdim * 2
    rng = np.random.default_rng(seed + 3)
    prompts = rng.integers(0, cfg.vocab, (n_convs, 1, prompt_len), dtype=np.int32)
    torch.cuda.synchronize()
    emit("ssm_setup", model=cfg.name, params=sum(p.numel() for p in _leaves(params)),
         param_bytes=sum(p.numel() * p.element_size() for p in _leaves(params)),
         layers=cfg.n_layers, d_model=cfg.d_model, heads=H, head_dim=P,
         d_state=N, chunk=s.chunk, prompt_len=prompt_len,
         conversations=n_convs, state_bytes=state_bytes, conv_bytes=conv_bytes,
         setup_s=time.perf_counter() - t0)

    def cluster(name: str, warm_pool: int) -> ClusterConfig:
        # lossless: a recurrent state has nothing to quantize, and a lossy
        # pager would only rewrite it whole before each demotion
        root = workdir / name
        return ClusterConfig(
            name=name,
            tiers=(TierSpec("dram"), TierSpec("pmem", path=str(root / "pmem"))),
            invokers=1, warm_pool=warm_pool, commit_every=1,
            journal="pmem", journal_path=str(root / "journal"),
            serving=ServingConfig(block_tokens=16, lossless=True),
        )

    def serve(client):
        return client.serving(params, cfg, prompt_len=prompt_len,
                              max_tokens=max_tokens, device=dev)

    ssd_spy = _Spy(ops, "ssd_chunk")
    counts = {}

    def mark(at: str) -> None:
        counts[at] = ssd_scan.launches

    ssd_scan.launches = 0  # the Mamba-2 serving path starts here
    try:
        # (a) more conversations than warm slots, steps interleaved: every
        # eviction pushes a state to PMEM, every next step resumes one
        with MarvelClient(cluster("ssm_pool", warm_pool=n_convs // 2)) as client:
            pool = serve(client)
            convs = [f"m{i}" for i in range(n_convs)]
            torch.cuda.synchronize()
            t = time.perf_counter()
            firsts = [_tok(pool.start(c, prompts[i])) for i, c in enumerate(convs)]
            prefill_s = time.perf_counter() - t
            mark("pool_prefilled")
            streams = {c: [] for c in convs}
            t = time.perf_counter()
            for _ in range(steps):
                for c in convs:
                    streams[c].append(_tok(pool.step(c)))
            torch.cuda.synchronize()
            pool_s = time.perf_counter() - t
            stats = pool.stats()
            layers, _ = pool.pager.load(pool._scoped(convs[0]))
        check(stats["demotions"] >= n_convs * steps and stats["resumes"] > 0,
              f"the pool did not evict and resume every step: {stats}")
        check([tuple(l.shape) for l in layers]
              == [(cfg.n_periods, 1, s.d_conv - 1, convdim),
                  (cfg.n_periods, 1, H, P, N)]
              and layers[1].dtype == torch.float32
              and all(l.device == dev for l in layers),
              "a resumed Mamba-2 session did not come back as its conv window "
              "and f32 state on the card")
        del layers
        toks = [x for c in convs for x in streams[c]] + firsts
        check(all(0 <= x < cfg.vocab for x in toks), "token out of vocabulary")
        emit("ssm_pool", conversations=n_convs, warm_pool=n_convs // 2,
             steps_each=steps, prefill_s=prefill_s,
             prefill_tokens_per_s=n_convs * prompt_len / prefill_s,
             decode_s=pool_s, tokens_per_s=n_convs * steps / pool_s,
             demotions=stats["demotions"], resumes=stats["resumes"],
             demand_faults=stats["demand_faults"],
             blocks_written=stats["blocks_written"])
        shutil.rmtree(workdir / "ssm_pool", ignore_errors=True)

        # (b) lossless suspend/resume and (c) a restart
        stream_c, _ = lossless_and_restart(
            cluster("ssm_lossless", warm_pool=8), serve, prompts, firsts,
            lossless_steps, mark, "ssm", dev)
    finally:
        ssd_spy.restore()
    launches = counts["after_restart"]  # ... and ends here
    check(counts["pool_prefilled"] >= n_convs * cfg.n_layers,
          f"ssd_chunk launched {counts['pool_prefilled']} times for "
          f"{n_convs} prefills of {cfg.n_layers} layers")
    check(counts["after_resume"] > counts["resumed"],
          "ssd_chunk did not launch after the resume")
    check(counts["after_restart"] > counts["after_resume"],
          "ssd_chunk did not launch after the restart")
    emit("ssm_launches", **counts)

    # (d) decode-step logits (the recurrent form, no kernel) against a fresh
    # prefill over the same tokens (the kernel; 1024 plus the new tokens is
    # no multiple of the chunk, so the zero-dt padding runs), with the
    # served weights computed in f32.  In bf16 this random 64-layer model
    # amplifies the rounding differences of the two forms (their GEMMs
    # see 1 row and 1036) to a few percent: that error is printed beside
    # the checked one, not held.
    tokens = torch.tensor([prompts[0, 0].tolist() + stream_c[:max_tokens]],
                          dtype=torch.int32, device=dev)
    f32 = _tree_map(lambda t: t.float(), params)
    rel, agree, n_dec = decode_vs_prefill(f32, cfg, tokens, prompt_len,
                                          max_tokens)
    del f32
    check(rel <= 2e-2, f"Mamba-2 decode vs prefill logits: relative L2 error "
          f"{rel} > 2e-2")
    bf16_rel, bf16_agree, _ = decode_vs_prefill(params, cfg, tokens,
                                                prompt_len, max_tokens)
    own = init_params(model_defs(cfg), torch.Generator(device=dev).manual_seed(seed), dev)
    own_rel, own_agree, _ = decode_vs_prefill(own, cfg, tokens, prompt_len,
                                              max_tokens)
    del own
    emit("ssm_consistency", positions=n_dec, weights="served, in f32",
         max_rel_l2=rel, argmax_agreement=agree, tolerance=2e-2,
         prefill_tokens=prompt_len + n_dec - 1, chunk=s.chunk,
         bf16_max_rel_l2=bf16_rel, bf16_argmax_agreement=bf16_agree,
         own_init_bf16_max_rel_l2=own_rel,
         own_init_bf16_argmax_agreement=own_agree)
    emit("ssm_profile", **profile_decode(params, cfg, tokens, prompt_len,
                                         max_tokens))
    return launches, ssd_spy.last


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return type(tree)(_tree_map(fn, v) for v in tree)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        for v in tree:
            yield from _leaves(v)


def _card() -> str:
    """Select card 0, print its name and power limit and return them."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    return card


def ptxas_report(logs: dict) -> dict:
    """Print one line per compiled kernel from ``nvcc -Xptxas -v``: its
    registers and spilled bytes (stores + loads); return the spilled bytes
    by (source, kernel)."""
    spills = {}
    for name, log in logs.items():
        kernel = spilled = None
        for line in log.splitlines():
            if "Function properties for" in line:
                kernel = line.split("Function properties for")[-1].strip()
            elif "spill stores" in line and kernel is not None:
                nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
                spilled = nums[1] + nums[2]  # stack frame, stores, loads
                spills[(name, kernel)] = spilled
            elif "Used" in line and "registers" in line and spilled is not None:
                regs = line.split("Used")[1].split("registers")[0].strip()
                print(f"ptxas {name}: {kernel[-70:]}: {regs} registers, "
                      f"{spilled} spill bytes")
                kernel = spilled = None
    return spills


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    card = _card()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    emit("build", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         build_s=build_s, sources=list(_build.SOURCES))
    spills = ptxas_report(_build.build_logs)
    tc_spills = {fn: n for (src, fn), n in spills.items()
                 if src in ("flash_attention", "decode_attention", "ssd_scan")
                 and n}
    check(not tc_spills, f"ptxas spills in the tensor-core kernels: {tc_spills}")
    phase_first_launch_threads(dev, args.seed)

    rec = KernelRecord()
    t0 = time.perf_counter()
    phase_kernel(dev, args.seed, rec, KERNEL_KEYS)
    emit("phase_done", name="kernel", s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_shuffle(dev, args.seed, SHUFFLE_TOKENS, STORAGE_TOKENS)
    torch.cuda.empty_cache()
    emit("phase_done", name="shuffle", s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    launches, largest = phase_main_path(
        dev, args.seed, CORPUS_BYTES, TERASORT_RECORDS
    )
    emit("phase_done", name="main_path", s=time.perf_counter() - t0)

    check(launches > 0, "bucket_histogram never launched on the main path")
    shape = hist_at_main_shape(rec, largest)
    emit("kernel_main_path_shape", **shape)

    flash_rec = AttnRecord("flash_attention")
    decode_rec = AttnRecord("decode_attention")
    t0 = time.perf_counter()
    phase_attention_kernels(dev, args.seed, flash_rec, decode_rec,
                            SERVE_PROMPT, SERVE_PROMPT + SERVE_MAX_TOKENS)
    emit("phase_done", name="attention_kernels", s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    from repro_torch.configs import get_config

    serve_cfg = get_config(SERVE_MODEL)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as workdir:
        serve_launches, flash_last, decode_last, params, hot_rate = phase_serving(
            dev, args.seed, serve_cfg, SERVE_PROMPT,
            SERVE_MAX_TOKENS, SERVE_CONVS, INT8_STEPS, LOSSLESS_STEPS,
            Path(workdir),
        )
    emit("phase_done", name="serving", s=time.perf_counter() - t0)
    (fq, fk, fv), fkw = flash_last
    flash_shape = measure_flash(fq, fk, fv, fkw)
    emit("flash_path_shape", **flash_shape)
    (dq, dk, dv, dlen), _ = decode_last
    decode_shape = measure_decode(dq, dk, dv, dlen)
    emit("decode_path_shape", **decode_shape)
    del flash_last, decode_last, fq, fk, fv, dq, dk, dv
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_traced_") as workdir:
        traced_launches = phase_traced_serving(
            dev, args.seed, serve_cfg, params, hot_rate, SERVE_PROMPT,
            SERVE_MAX_TOKENS, Path(workdir),
        )
    del params
    torch.cuda.empty_cache()
    emit("phase_done", name="traced_serving", s=time.perf_counter() - t0)

    ssd_rec = SSDRecord()
    t0 = time.perf_counter()
    phase_ssd_kernel(dev, args.seed, ssd_rec)
    torch.cuda.empty_cache()
    emit("phase_done", name="ssd_kernel", s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ssm_") as workdir:
        ssd_launches, ssd_last = phase_ssm_serving(
            dev, args.seed, get_config(SSM_MODEL), SSM_PROMPT, SSM_MAX_TOKENS,
            SSM_CONVS, SSM_STEPS, SSM_LOSSLESS_STEPS, Path(workdir),
        )
    emit("phase_done", name="ssm_serving", s=time.perf_counter() - t0)
    ssd_shape = measure_ssd(*ssd_last[0])
    emit("ssd_path_shape", **ssd_shape)

    def row(name, source, replaces, n, record_err, checks, m, extra):
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n, "max_abs_err": record_err,
            "checks": checks, "ms": m["kernel_ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "shape": extra,
        }

    print(card, flush=True)  # again, beside the numbers below
    print(json.dumps({"kernels": [
        {**row("bucket_histogram", "src/repro_torch/csrc/bucket_histogram.cu",
               "src/repro/kernels/bucket_histogram.py:79", launches,
               rec.max_abs_err, rec.checks, shape,
               {"n": shape["n"], "n_buckets": shape["n_buckets"]}),
         "kernel_route": shape["kernel_route"],
         "device_ms": shape["device_ms"],
         "library_device_ms": shape["library_device_ms"],
         "device_ops_per_call": shape["device_ops_per_call"],
         "launch_floor_ms": shape["launch_floor_ms"],
         "launch_floor_device_ms": shape["launch_floor_device_ms"]},
        {**row("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention.py:138",
               serve_launches["flash_attention"], flash_rec.max_abs_err,
               flash_rec.checks, flash_shape, flash_shape["shape"]),
         "kernel_route": flash_shape["kernel_route"],
         "device_ms": flash_shape["device_ms"],
         "library_device_ms": flash_shape["library_device_ms"],
         "traced_launches": traced_launches["flash_attention"]},
        {**row("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
               "src/repro/kernels/decode_attention.py:127",
               serve_launches["decode_attention"], decode_rec.max_abs_err,
               decode_rec.checks, decode_shape, decode_shape["shape"]),
         "kernel_route": decode_shape["kernel_route"],
         "device_ms": decode_shape["device_ms"],
         "library_device_ms": decode_shape["library_device_ms"],
         "traced_launches": traced_launches["decode_attention"]},
        {**row("ssd_chunk", "src/repro_torch/csrc/ssd_scan.cu",
               "src/repro/kernels/ssd_scan.py:80", ssd_launches,
               ssd_rec.max_abs_err, ssd_rec.checks, ssd_shape,
               ssd_shape["shape"]),
         "kernel_route": ssd_shape["kernel_route"],
         "device_ms": ssd_shape["device_ms"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
