#!/usr/bin/env python3
"""Check the port's sharded paths across four GPUs over NCCL.

    python3 chip_dist4.py [--seed N] [--device cpu] [--witness]

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
   takes a2a at T 256 and gather at T 1;
3. the sharded train step (``make_train_step(mesh=...)``) on a (2, 2) and
   a (4, 1) mesh against the one-process step on the rank's own card,
   both computing in f32 (``launch.steps.COMPUTE_DTYPE``): qwen2.5-3b at
   full width cut to 2 layers, 2 steps of 8 sequences of 1024 in 2
   microbatches, remat "full", from the same parameters, drawn as
   ``chip_smoke.py``'s training phases draw them (attention at its true
   fan-in): losses and grad norms within 1e-5 relative, the update
   (``p2 - p0`` over the whole tree) within 2e-3 relative L2 (the bound
   ``tests/test_torch_launch.py`` holds the example's update to, for
   AdamW's near-sign first steps), and the flash forward and
   backward launched; the final parameters' relative L2 is printed.  The
   same comparison from the shared init rule's draw is printed, not
   held: with it the (4, 1) mesh, pure data parallelism, departs as far
   as (2, 2) does.

``--witness`` runs on one card with no process group: check 3's
one-process step, from both draws, against itself at 4 and 8
microbatches (the rows a forward that a rank of (2, 2) and of (4, 1)
computes), printed, not held.  It tells whether a draw's departure comes
with the shapes and the order of the sums, with no sharded code involved.

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
TRAIN_MODEL = "qwen2.5-3b"
TRAIN_LAYERS = 2
TRAIN_SHAPE = (8, 1024, 2)  # (batch, seq, microbatches); seq 32 on the CPU
TRAIN_STEPS = 2
LOSS_LIMIT = 1e-5  # losses and grad norms, relative
UPDATE_LIMIT = 2e-3  # the update p2 - p0, relative L2 over the whole tree
WITNESS_MICROBATCHES = (4, 8)  # --witness: 2 and 1 rows a forward


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
        del p32, x32, p16, x16, local, want, want16
        _sharded_train(rank, seed, device_type, dev, report)


def _train_setup(device_type: str):
    """Check 3's model, f32 compute, batches and optimizer; returns
    ``(cfg, shape_of(microbatches), batches, opt_cfg)``."""
    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, make_batch
    from repro_torch.launch import steps
    from repro_torch.models import ShapeConfig, reduced_for_smoke
    from repro_torch.optim import AdamWConfig

    steps.COMPUTE_DTYPE = torch.float32
    cfg = replace(get_config(TRAIN_MODEL), n_periods=TRAIN_LAYERS)
    B, T, _ = TRAIN_SHAPE
    if device_type != "cuda":
        cfg, T = reduced_for_smoke(cfg), 32

    def shape_of(n_mb: int) -> "ShapeConfig":
        return ShapeConfig(name="train_f32", kind="train", seq_len=T, global_batch=B,
                           microbatches=n_mb, q_chunk=512, kv_chunk=1024,
                           loss_chunk=512, remat="full")

    pipe = PipelineConfig(vocab=cfg.vocab, seq_len=T, global_batch=B)
    batches = [make_batch(pipe, s) for s in range(TRAIN_STEPS)]
    return cfg, shape_of, batches, AdamWConfig(lr=3e-4, weight_decay=0.0)


def _draws(cfg, seed: int, dev):
    """The two parameter draws of check 3, each the same on every card:
    the training phases' (attention at its true fan-in) and the shared
    init rule's."""
    import chip_smoke
    from repro_torch.launch.train import init_state

    return (("fan_in", lambda: chip_smoke._draw_train_params(cfg, seed + 2, dev)),
            ("shared_init", lambda: init_state(cfg, dev, seed + 2)[0]))


def _train_run(cfg, shape, opt_cfg, batches, params0, dev, mesh=None):
    """The steps of ``batches`` from a copy of ``params0`` (sharded on
    ``mesh``, or one process); returns (losses, grad norms, the whole final
    parameters, flash forward and backward launches)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.launch import make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import param_pspecs, shard_tree, unshard_tree
    from repro_torch.tree import tree_map

    params = tree_map(torch.clone, params0)
    specs = None if mesh is None else param_pspecs(cfg, mesh)
    if specs is not None:
        params = shard_tree(params, specs, mesh)
    opt = adamw_init(params)
    fn = make_train_step(cfg, shape, opt_cfg, device=dev, mesh=mesh)
    launches = (fa.launches, fb.launches)
    losses, norms = [], []
    for batch in batches:
        params, opt, m = fn(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    launches = (fa.launches - launches[0], fb.launches - launches[1])
    del opt
    if specs is not None:
        params = unshard_tree(params, specs, mesh)
    return losses, norms, params, launches


def _compare(got, want, p0) -> dict:
    """How far run ``got`` departs from run ``want`` (each
    :func:`_train_run`'s result) that started from ``p0``."""
    from repro_torch.tree import tree_leaves

    def rel_l2(a_list, b_list) -> float:
        diff = sum(float((a.double() - b.double()).square().sum())
                   for a, b in zip(a_list, b_list))
        return (diff / sum(float(b.double().square().sum()) for b in b_list)) ** 0.5

    p0 = tree_leaves(p0)
    got_p, want_p = tree_leaves(got[2]), tree_leaves(want[2])
    return dict(
        losses=got[0], want_losses=want[0], grad_norms=got[1], want_grad_norms=want[1],
        loss_rel=max(abs(a - b) / abs(b) for a, b in zip(got[0], want[0])),
        grad_norm_rel=[abs(a - b) / abs(b) for a, b in zip(got[1], want[1])],
        update_rel_l2=rel_l2([a - b for a, b in zip(got_p, p0)],
                             [a - b for a, b in zip(want_p, p0)]),
        params_rel_l2=rel_l2(got_p, want_p))


def _sharded_train(rank: int, seed: int, device_type: str, dev, report) -> None:
    """Check 3: the sharded step against the one-process step, in f32."""
    from repro_torch.launch import make_mesh_compat

    cfg, shape_of, batches, opt_cfg = _train_setup(device_type)
    shape = shape_of(TRAIN_SHAPE[2])
    # the training phases' draw, held; the shared init rule's, printed
    for draw, make in _draws(cfg, seed, dev):
        params0 = make()
        want = _train_run(cfg, shape, opt_cfg, batches, params0, dev)
        for name, mesh_shape in (("2x2", (2, 2)), ("4x1", (4, 1))):
            mesh = make_mesh_compat(mesh_shape, ("data", "model"), device_type)
            got = _train_run(cfg, shape, opt_cfg, batches, params0, dev, mesh)
            gap = _compare(got, want, params0)
            launches = got[3]
            ran = device_type != "cuda" or min(launches) > 0
            held = draw == "fan_in"
            report("sharded_train_f32", not held or (
                gap["loss_rel"] <= LOSS_LIMIT and max(gap["grad_norm_rel"]) <= LOSS_LIMIT
                and gap["update_rel_l2"] <= UPDATE_LIMIT and ran), draw=draw, held=held,
                mesh=name, model=cfg.name, layers=cfg.n_layers, seq=shape.seq_len,
                flash_launches=launches[0], flash_bwd_launches=launches[1], **gap)
            del got
        del params0, want


def _witness(seed: int, device_type: str) -> None:
    """``--witness``, one card and no process group: check 3's one-process
    step with TRAIN_SHAPE's microbatches (4 rows a forward) against the
    same step with 4 and 8 microbatches (2 rows a forward, as a rank of
    the (2, 2) mesh runs them, and 1, as a rank of (4, 1)), from both
    draws.  The same function of the same parameters, summed in another
    order and computed at other shapes, with no sharded code on the way:
    it prints how far each departs, and holds nothing."""
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device(device_type)
    cfg, shape_of, batches, opt_cfg = _train_setup(device_type)
    for draw, make in _draws(cfg, seed, dev):
        params0 = make()
        want = _train_run(cfg, shape_of(TRAIN_SHAPE[2]), opt_cfg, batches, params0, dev)
        for n_mb in WITNESS_MICROBATCHES:
            got = _train_run(cfg, shape_of(n_mb), opt_cfg, batches, params0, dev)
            print(json.dumps({"check": "microbatch_witness", "draw": draw,
                              "microbatches": n_mb, "against": TRAIN_SHAPE[2],
                              "rows_a_forward": TRAIN_SHAPE[0] // n_mb,
                              "model": cfg.name, "layers": cfg.n_layers,
                              "seq": batches[0]["tokens"].shape[1],
                              **_compare(got, want, params0)}), flush=True)
            del got
        del params0, want


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--witness", action="store_true",
                    help="on one card: check 3's one-process step at more "
                         "microbatches against its own (nothing held)")
    args = ap.parse_args(argv)
    need = 1 if args.witness else WORLD
    if args.device == "cuda" and torch.cuda.device_count() < need:
        print(f"chip_dist4: needs {need} GPUs, sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 1
    import torch.multiprocessing as mp

    if args.device == "cuda":  # once, before the ranks load the kernels
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.kernels import _build
        _build.build()
    if args.witness:
        _witness(args.seed, args.device)
    else:
        with tempfile.TemporaryDirectory(prefix="chip_dist4_") as tmp:
            mp.start_processes(_rank, args=(args.seed, args.device,
                                            os.path.join(tmp, "rdzv")),
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
