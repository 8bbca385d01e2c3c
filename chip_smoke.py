#!/usr/bin/env python3
"""Drive Marvel's PyTorch/CUDA port on one GPU and check what comes out.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with an NVIDIA H100 (or
another sm_90a card).  It builds the port's CUDA kernels from
``src/repro_torch/csrc`` with ``nvcc`` into ``build/repro_torch/``, then:

1. prints the card's name and power limit, the torch and CUDA versions
   and the kernel build time;
2. holds ``bucket_histogram`` against its plain PyTorch version on the
   card: the contract's edge cases, then 2^28 int32 keys (1 GiB, 10 %
   padding, 1 % >= n_buckets) for n_buckets in {4, 128, 32000}, with
   kernel, plain-version and ``torch.bincount`` times (CUDA events, median
   of 15 after warm-up) beside the memory bound;
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
5. prints a ``kernels`` JSON line: each kernel's launches on the main
   path and its check and times at the main path's largest shape.

Every check that fails raises, and the script exits non-zero.  The last
line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
rest of the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
REPS = 15
# Sizes of the run (see the module docstring for why these).
KERNEL_KEYS = 1 << 28  # 1 GiB of int32 keys
SHUFFLE_TOKENS = 1 << 28  # 1 GiB of tokens plus 1 GiB of values
STORAGE_TOKENS = 1 << 24
CORPUS_BYTES = 64 << 20
TERASORT_RECORDS = 1 << 19


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


# -- phase 2: the kernel against its plain version ----------------------------

class KernelRecord:
    """What the ``kernels`` line reports for ``bucket_histogram``."""

    def __init__(self) -> None:
        self.max_abs_err = 0
        self.checks = 0

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
        check(got.dtype == torch.int32 and got.shape == (n_buckets,),
              f"kernel output {got.dtype} {tuple(got.shape)}")
        check(torch.equal(got, plain), f"kernel != plain (n={keys.numel()}, "
              f"n_buckets={n_buckets}, max abs err {err})")
        check(torch.equal(got.long(), library), "kernel != torch.bincount")
        return got

    def measure(self, keys: torch.Tensor, n_buckets: int) -> dict:
        from repro_torch.kernels import bucket_histogram as bh

        self.compare(keys, n_buckets)
        valid = keys[(keys >= 0) & (keys < n_buckets)]
        before = bh.launches
        kernel_ms = time_ms(lambda: bh.bucket_histogram(keys, n_buckets))
        launches = bh.launches - before
        plain_ms = time_ms(lambda: bh.bucket_histogram_torch(keys, n_buckets))
        library_ms = time_ms(
            lambda: torch.bincount(valid, minlength=n_buckets)
        )
        n = keys.numel()
        return {
            "n": n, "n_buckets": n_buckets, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bytes_bound_ms(4 * n + 4 * n_buckets),
            "bound_by": "bytes", "launches": launches,
        }


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
        "global_atomics": (randint(-1, 70000, 100003), 70000),
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

    for nb in (4, 128, 32000):
        keys = randint(0, nb, n)
        u = torch.rand(n, generator=g, device=dev)
        keys[u < 0.10] = -1  # padding
        keys[(u >= 0.10) & (u < 0.11)] = nb + 7  # dropped: >= n_buckets
        del u
        emit("kernel", **rec.measure(keys, nb))
        del keys
        torch.cuda.empty_cache()


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


def _card() -> torch.device:
    """Select card 0 and print its name and power limit."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    return dev


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

    dev = _card()
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    emit("build", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         build_s=build_s, sources=list(_build.SOURCES))
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line:
                print(f"ptxas {name}: {line.strip()}")

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
    shape = rec.measure(largest["dest"], largest["n_parts"])
    emit("kernel_main_path_shape", **shape)
    print(json.dumps({"kernels": [{
        "name": "bucket_histogram",
        "route": "cuda",
        "source": "src/repro_torch/csrc/bucket_histogram.cu",
        "replaces": "src/repro/kernels/bucket_histogram.py:79",
        "launches": launches,
        "max_abs_err": rec.max_abs_err,
        "checks": rec.checks,
        "ms": shape["kernel_ms"],
        "plain_ms": shape["plain_ms"],
        "bound_ms": shape["bound_ms"],
        "bound_by": "bytes",
        "library_ms": shape["library_ms"],
        "shape": {"n": shape["n"], "n_buckets": shape["n_buckets"]},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
