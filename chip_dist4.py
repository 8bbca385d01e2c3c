#!/usr/bin/env python3
"""Check the port's sharded paths across four GPUs over NCCL.

    python3 chip_dist4.py [--seed N] [--device cpu]

Run from the root of a checkout on a host with 4 GPUs (``--device cpu``:
4 gloo processes on the CPU at a reduced width, a rehearsal).  It spawns
4 ranks, one card each, which meet through a rendezvous file in a
temporary directory, and every rank checks:

1. ``device_histogram`` with its own shard of 2^24 Zipf(1.1) keys over
   32000 buckets on a (4,) mesh over "data" and on a (2, 2) mesh over
   ("data", "model") (each "model" pair passing the same shard): at
   capacity factor 8, where nothing drops, the counts byte for byte and
   the accounting of the one-device call over the whole input on the
   rank's own card; at 0.05, dropping and spilling to a DRAM tier, those
   of ``storage_histogram`` over as many shards (the same plan, shard
   after shard in one process; the CPU tests hold it to the reference);
2. ``moe_apply_a2a`` and ``moe_apply_gather`` on the (2, 2) mesh for one
   deepseek-v2-lite-16b MoE layer at full width (64 experts, 32 a rank;
   d_model 2048 sliced over "data" unless ``zero1``), 2 x 256 tokens at
   capacity factor 16 (no entry drops): within 2e-4 of
   ``moe_apply_dense`` on one card in f32 (``zero1`` both ways), and in
   bf16 within relative L2 2e-2 of the dense path in f32; ``moe_apply``
   takes a2a at T 256 and gather at T 1.

It measures no time.  Rank 0 prints one JSON line per check, then the
card's name and power limit, and last ``{"ok": true, ...}``; a rank that
fails makes the script exit non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from dataclasses import replace
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
WORLD = 4
TOKENS = 1 << 24
VOCAB = 32000
MOE_MODEL = "deepseek-v2-lite-16b"
MOE_SHAPE = (2, 256)
F32_LIMIT = 2e-4
BF16_LIMIT = 2e-2


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


def _cast(tree, dtype):
    """Every leaf but the f32 router cast to ``dtype``."""
    return {k: _cast(v, dtype) if isinstance(v, dict)
            else v if k == "router" else v.to(dtype) for k, v in tree.items()}


def _rank(rank: int, seed: int, device_type: str, rdzv: str) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core import device_histogram, storage_histogram
    from repro_torch.launch import make_mesh_compat, process_group
    from repro_torch.models import init_params, moe, reduced_for_smoke
    from repro_torch.storage import DramTier

    def report(check: str, ok: bool, **fields) -> None:
        if rank == 0:
            print(json.dumps({"check": check, "ok": ok, **fields}), flush=True)
        if not ok:
            raise AssertionError(f"rank {rank}: {check} {fields}")

    with process_group(rank, WORLD, rdzv, device_type):
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if device_type == "cuda" else torch.device("cpu")
        meshes = {"4": make_mesh_compat((4,), ("data",), device_type),
                  "2x2": make_mesh_compat((2, 2), ("data", "model"), device_type)}
        n = TOKENS if device_type == "cuda" else 1 << 16
        g = torch.Generator().manual_seed(seed)
        cdf = torch.cumsum(torch.arange(1, VOCAB + 1, dtype=torch.float64) ** -1.1, 0)
        keys = torch.searchsorted((cdf / cdf[-1]).float(), torch.rand(n, generator=g),
                                  out_int32=True).clamp_(max=VOCAB - 1).to(dev)
        values = torch.ones_like(keys)
        keys_h, values_h = keys.cpu().numpy(), values.cpu().numpy()
        fields = ("dropped", "shuffled_bytes", "spilled", "spilled_bytes")
        for cf, spill in ((8.0, False), (0.05, False), (0.05, True)):
            tier = DramTier if spill else (lambda: None)
            for name, mesh in meshes.items():
                ndev = mesh.size(0)
                me = mesh.get_local_rank("data")
                part = -(-n // ndev)
                got = device_histogram(
                    keys[me * part:(me + 1) * part], values[me * part:(me + 1) * part],
                    vocab=VOCAB, capacity_factor=cf, spill_tier=tier(), mesh=mesh)
                if cf == 8.0:  # nothing drops: the one-device call's result
                    want = device_histogram(keys, values, 1, vocab=VOCAB,
                                            capacity_factor=cf, device=dev)
                    against = "one_device"
                else:  # the same plan, one shard after another, in one process
                    want = storage_histogram(keys_h, values_h, ndev, DramTier(),
                                             vocab=VOCAB, capacity_factor=cf,
                                             spill=spill, device=dev)
                    against = "storage_histogram"
                ok = (got.counts.dtype == want.counts.dtype
                      and torch.equal(got.counts, want.counts)
                      and all(int(getattr(got, f)) == int(getattr(want, f))
                              for f in fields))
                report("device_histogram", ok, mesh=name, tokens=n, vocab=VOCAB,
                       capacity_factor=cf, spill=spill, against=against,
                       byte_equal=ok, spilled=int(got.spilled),
                       dropped=int(got.dropped))

        cfg = get_config(MOE_MODEL)
        if device_type != "cuda":
            cfg = reduced_for_smoke(cfg)
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=16.0))
        # the same draw on every rank's card
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        p32 = init_params(moe.moe_defs(cfg), g, dev, dtype=torch.float32)
        B, T = MOE_SHAPE
        x32 = torch.randn((B, T, cfg.d_model), generator=g, device=dev)
        mesh = meshes["2x2"]
        paths = {"a2a": moe.moe_apply_a2a, "gather": moe.moe_apply_gather}
        with torch.no_grad():
            want, _ = moe.moe_apply_dense(p32, x32, cfg)
            for zero1 in (False, True):
                local = moe.shard_params(p32, mesh, zero1=zero1)
                for name, fn in paths.items():
                    got, _ = fn(local, x32, cfg, mesh, ("data",), "model", zero1)
                    err = float((got - want).abs().max())
                    ok = bool(torch.allclose(got, want, atol=F32_LIMIT, rtol=F32_LIMIT))
                    report("moe_f32", ok, path=name, zero1=zero1, max_abs_err=err,
                           w_gate_local=list(local["w_gate"].shape))
            p16 = _cast(p32, torch.bfloat16)
            x16 = x32.to(torch.bfloat16)
            want16, _ = moe.moe_apply_dense(_cast(p16, torch.float32), x16.float(), cfg)
            local = moe.shard_params(p16, mesh)
            for name, fn in paths.items():
                got, _ = fn(local, x16, cfg, mesh, ("data",), "model")
                rel = _rel_l2(got, want16)
                report("moe_bf16", rel <= BF16_LIMIT, path=name, rel_l2=rel)
            local = moe.shard_params(p32, mesh)
            for T_call, path in ((T, "a2a"), (1, "gather")):
                xs = x32[:, :T_call]
                picked, _ = moe.moe_apply(local, xs, cfg, mesh)
                explicit, _ = paths[path](local, xs, cfg, mesh, ("data",), "model")
                dense, _ = moe.moe_apply_dense(p32, xs, cfg)
                err = float((picked - dense).abs().max())
                ok = torch.equal(picked, explicit) and bool(
                    torch.allclose(picked, dense, atol=F32_LIMIT, rtol=F32_LIMIT))
                report("moe_apply", ok, T=T_call, path=path, max_abs_err=err)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and torch.cuda.device_count() < WORLD:
        print(f"chip_dist4: needs {WORLD} GPUs, sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 1
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="chip_dist4_") as tmp:
        mp.start_processes(_rank, args=(args.seed, args.device, os.path.join(tmp, "rdzv")),
                           nprocs=WORLD, join=True, start_method="spawn")
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip(), flush=True)
    print("no multi-GPU time measured", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu" if args.device == "cuda" else "cpu",
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
