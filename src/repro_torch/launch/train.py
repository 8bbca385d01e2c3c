"""End-to-end training launcher with stateful-serverless semantics.

The port of ``repro/launch/train.py`` for one card.  The training job runs
as a Marvel-style stateful application:

  * model and optimizer state live on the card (the hot tier),
  * an async :class:`~repro_torch.storage.CheckpointManager` drains
    snapshots to the PMEM tier (files) every ``--checkpoint-every`` steps,
  * ``--fail-at N`` injects a crash at step N: every tensor of the device
    state is dropped, and the loop restores from the last durable
    checkpoint and resumes: the paper's §4.3 fault-tolerance story
    (with ``--compress-grads`` the error-feedback residual is state too,
    checkpointed under ``"ef"`` beside the reference's two keys),
  * the data pipeline is deterministic in (seed, step), and the step is
    deterministic on the card (the attention backward kernel has no
    atomics), so the resumed run replays the losses it would have had.

Every token-frontend configuration trains: dense attention and MLA on
the flash backward kernel (MLA at q/k 192 against v 128), Mamba-2 on the
SSD chunk's backward kernel, RG-LRU as a scan of torch ops, MoE through
its dense path (deterministic under ``backward()``), or expert-parallel on
a mesh whose TP divides the experts.

``--mesh D M`` trains on a (data, model) mesh of D·M ranks spawned on this
host (``torch.multiprocessing``, ``spawn``), which meet through a
rendezvous file: NCCL with rank r on card r, or gloo with ``--device
cpu``; the sharded step of ``launch.steps`` (the reference's FSDP×TP
step), for every ``--arch``.  ``--full-mesh`` asks for the production
16×16 mesh: 256 ranks, one card each, refused where the host has fewer
cards and always with ``--device cpu``.  Checkpoints keep the
one-process blob format (the reference's leaves): rank 0 writes the whole
tree, gathered one leaf at a time, and every rank restores it by reading
the checkpoint and keeping its own blocks, so a checkpoint written on one
mesh restores on another and in the one-process launcher.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --steps 40 --reduced --ckpt-dir CKPT_DIR [--fail-at 25] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \\
      --full --seq 4096 --batch 4 --microbatches 4 --steps 4 --ckpt-dir CKPT_DIR
  PYTHONPATH=src python -m repro_torch.launch.train --mesh 2 1 --device cpu \\
      --steps 8 --ckpt-dir CKPT_DIR [--fail-at 6] [--compress-grads]
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import PipelineConfig, make_batch
from repro_torch.launch.mesh import make_mesh_compat, process_group, production_mesh_shape
from repro_torch.launch.steps import make_train_step
from repro_torch.models import ShapeConfig, init_params, model_defs, reduced_for_smoke
from repro_torch.models.convert import to_tensor
from repro_torch.models.param import tree_map_defs
from repro_torch.optim.adamw import AdamWConfig, OptState, adamw_init
from repro_torch.parallel.sharding import (
    param_pspecs, shard_tree, spec_leaves, unshard_tree)
from repro_torch.storage import CheckpointManager, PmemTier
from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = ["build", "init_state", "restore_state", "train", "run_on_mesh",
           "parse_args", "main"]


def build(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_for_smoke(cfg)
    shape = ShapeConfig(
        name="cli", kind="train", seq_len=args.seq, global_batch=args.batch,
        microbatches=args.microbatches, q_chunk=min(512, args.seq),
        kv_chunk=min(1024, args.seq), loss_chunk=min(512, args.seq),
        remat="none" if args.reduced else "full",
    )
    return cfg, shape


def init_state(cfg, device, seed: int = 0):
    """f32 master parameters drawn from ``seed`` and zero AdamW state."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(model_defs(cfg), gen, device, dtype=torch.float32)
    return params, adamw_init(params)


def _skeleton(cfg) -> tuple:
    """The (params, opt) tree structure, with placeholder leaves."""
    params = tree_map_defs(lambda pd: 0, model_defs(cfg))
    return params, OptState(mu=params, nu=params, step=0)


def restore_state(ckpt: CheckpointManager, cfg, device, step: Optional[int] = None,
                  mesh=None):
    """(params, opt) from the checkpoint at ``step`` (default: the newest
    durable one) on ``device``: the leaves the reference's launcher writes,
    ``{"params": leaves, "opt": leaves}``, so either package's
    checkpoints restore.  With ``mesh``, this rank's shards."""
    params, opt, _ = _restore(ckpt, cfg, device, step, mesh)
    return params, opt


def _restore(ckpt: CheckpointManager, cfg, device, step: Optional[int] = None,
             mesh=None):
    """(params, opt, ef): :func:`restore_state` plus the error-feedback
    residual of a compressed run, stored under ``"ef"`` beside the
    reference's two keys (None when the checkpoint has none)."""
    state = ckpt.restore(step)
    like_p, like_o = _skeleton(cfg)
    specs = None if mesh is None else param_pspecs(cfg, mesh)

    def tree(leaves):  # whole on the host, then each leaf's block
        t = tree_unflatten(like_p, [to_tensor(x) for x in leaves])
        if specs is not None:
            t = shard_tree(t, specs, mesh)
        return tree_unflatten(like_p, [x.to(device) for x in tree_leaves(t)])

    n = len(tree_leaves(like_p))
    params = tree(state["params"])
    opt = OptState(mu=tree(state["opt"][:n]), nu=tree(state["opt"][n:2 * n]),
                   step=to_tensor(state["opt"][2 * n], device))
    ef = None
    if "ef" in state:
        from repro_torch.optim.compression import EFState
        ef = EFState(residual=tree(state["ef"]))
    return params, opt, ef


def _whole_leaves(tree, specs, mesh) -> Optional[List[torch.Tensor]]:
    """The leaves of a tree of shards gathered whole one at a time, on the
    host at rank 0 (None elsewhere): every rank must call it."""
    out = []
    for leaf, spec in zip(tree_leaves(tree), spec_leaves(specs)):
        whole = unshard_tree(leaf, spec, mesh)
        if dist.get_rank() == 0:
            out.append(whole.cpu())
        del whole
    return out if dist.get_rank() == 0 else None


def _state(params, opt, ef, specs, mesh) -> Optional[Dict[str, Any]]:
    """The checkpoint's tree: the leaves as the one-process launcher
    writes them (gathered whole with a mesh; None off rank 0)."""
    if mesh is None:
        state = {"params": tree_leaves(params), "opt": tree_leaves(opt)}
        if ef is not None:
            state["ef"] = tree_leaves(ef.residual)
        return state
    state = {"params": _whole_leaves(params, specs, mesh),
             "opt": _whole_leaves([opt.mu, opt.nu], [specs, specs], mesh)}
    if ef is not None:
        state["ef"] = _whole_leaves(ef.residual, specs, mesh)
    if dist.get_rank() != 0:
        return None
    state["opt"].append(opt.step.cpu())
    return state


def _residual(ef, params, compress_grads: bool):
    """The residual a run carries: none when it does not compress, else the
    checkpoint's, or zeros when the checkpoint came from an uncompressed
    run (or there is none)."""
    if not compress_grads:
        return None
    if ef is None:
        from repro_torch.optim.compression import ef_init
        ef = ef_init(params)
    return ef


def _drop_device_state() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def train(
    cfg,
    shape: ShapeConfig,
    opt_cfg: AdamWConfig,
    ckpt: CheckpointManager,
    *,
    steps: int,
    checkpoint_every: int,
    fail_at: Optional[int] = None,
    compress_grads: bool = False,
    device: Any = "cuda",
    seed: int = 0,
    params: Any = None,
    log: Callable[[str], None] = print,
    mesh=None,
) -> Dict[str, Any]:
    """The training loop: resume from ``ckpt``'s newest checkpoint if it
    has one (else start from ``params``, or draw them from ``seed``), run
    to ``steps``, checkpoint every ``checkpoint_every`` steps, and at
    ``fail_at`` drop the device state and restore.  Returns the history
    (one record a step run, replays included), the checkpoints written,
    and the restore's step and seconds.

    With ``mesh`` (every rank of it calls this) the step is sharded:
    ``params``, when given, are whole and each rank keeps its blocks; the
    returned ``params`` and ``opt`` are this rank's shards; only rank 0
    writes checkpoints and logs."""
    device = torch.device(device)
    step_fn = make_train_step(cfg, shape, opt_cfg, compress_grads=compress_grads,
                              device=device, mesh=mesh)
    specs = None if mesh is None else param_pspecs(cfg, mesh)
    lead = mesh is None or dist.get_rank() == 0
    if not lead:
        log = lambda s: None  # noqa: E731
    start = ckpt.latest_step()
    ef = None
    if start is not None:
        params, opt, ef = _restore(ckpt, cfg, device, mesh=mesh)
        log(f"resumed from durable checkpoint @ step {start}")
    else:
        if params is None:
            params = init_state(cfg, device, seed)[0]
        if specs is not None:
            params = shard_tree(params, specs, mesh)
        opt = adamw_init(params)
    ef = _residual(ef, params, compress_grads)
    pipe = PipelineConfig(vocab=cfg.vocab, seq_len=shape.seq_len,
                          global_batch=shape.global_batch)
    history: List[Dict[str, float]] = []
    saves, restores = [], []
    failed = False
    step = int(start or 0)
    while step < steps:
        t0 = time.perf_counter()
        out = step_fn(params, opt, make_batch(pipe, step), *((ef,) if ef is not None else ()))
        params, opt, metrics = out[:3]
        if ef is not None:
            ef = out[3]
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        step += 1
        history.append({"step": step, "loss": loss, "grad_norm": gnorm,
                        "tokens": int(metrics["tokens"]),
                        "step_s": time.perf_counter() - t0})
        if step % 5 == 0 or step == steps:
            log(f"step {step:5d}  loss {loss:.4f}  gnorm {gnorm:.3f}")
        if step % checkpoint_every == 0:
            # the residual is state: a replay needs it
            state = _state(params, opt, ef, specs, mesh)
            if lead:
                saves.append(ckpt.save(step, state))
            del state
        if fail_at is not None and step == fail_at and not failed:
            failed = True
            log(f"!! injected crash at step {step}: dropping all state")
            params = opt = ef = metrics = out = None
            _drop_device_state()
            t0 = time.perf_counter()
            ckpt.wait()
            if mesh is not None:  # rank 0's checkpoint is durable for all
                dist.barrier()
            restore_step = ckpt.latest_step()
            if restore_step is None:
                raise SystemExit("no durable checkpoint: job lost (the "
                                 "stock-serverless failure the paper fixes)")
            params, opt, ef = _restore(ckpt, cfg, device, mesh=mesh)
            ef = _residual(ef, params, compress_grads)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            restores.append({"step": restore_step,
                             "restore_s": time.perf_counter() - t0})
            step = restore_step
            log(f"recovered from PMEM tier @ step {restore_step}; resuming")
    ckpt.wait()
    if mesh is not None:
        dist.barrier()
    return {"history": history, "saves": saves, "restores": restores,
            "params": params, "opt": opt}


def _mesh_of(args):
    """(shape, axes) of the mesh ``args`` ask for, or None for one process.
    On the card a mesh needs a card a rank; ``--full-mesh`` (256 ranks)
    is refused on the CPU whatever the host."""
    if args.full_mesh:
        shape, axes = production_mesh_shape()
    elif args.mesh is not None:
        shape, axes = tuple(args.mesh), ("data", "model")
    else:
        return None
    n = math.prod(shape)
    cuda = torch.device(args.device).type == "cuda"
    have = torch.cuda.device_count() if cuda else None
    if (args.full_mesh and not cuda) or (cuda and n > have):
        raise ValueError(f"a mesh of shape {shape} needs {n} ranks, one card each; "
                         + (f"this host has {have} cards" if cuda
                            else "not run as gloo processes on the CPU"))
    return shape, axes


def _rank_main(rank: int, args, mesh_shape, workdir: str) -> None:
    """One rank of :func:`run_on_mesh`: join the world, train, and at rank
    0 write the history beside the rendezvous file."""
    shape, axes = mesh_shape
    n = math.prod(shape)
    cuda = torch.device(args.device).type == "cuda"
    device = torch.device("cuda", rank % torch.cuda.device_count()) if cuda else "cpu"
    with process_group(rank, n, os.path.join(workdir, "rdzv"),
                       None if cuda else "cpu"):
        mesh = make_mesh_compat(shape, axes, None if cuda else "cpu")
        cfg, tshape = build(args)
        ckpt = CheckpointManager(PmemTier(args.ckpt_dir), f"train/{cfg.name}", keep=2)
        try:
            out = train(cfg, tshape, AdamWConfig(lr=args.lr, weight_decay=0.0), ckpt,
                        steps=args.steps, checkpoint_every=args.checkpoint_every,
                        fail_at=args.fail_at, compress_grads=args.compress_grads,
                        device=device, mesh=mesh)
        finally:
            ckpt.close()
    if rank == 0:
        with open(os.path.join(workdir, "history.json"), "w") as f:
            json.dump(out["history"], f)


def run_on_mesh(args) -> List[Dict[str, float]]:
    """Train as ``args`` say on their mesh (``--mesh`` or ``--full-mesh``):
    one spawned process per rank on this host; returns rank 0's history."""
    import torch.multiprocessing as mp

    mesh_shape = _mesh_of(args)
    if mesh_shape is None:
        raise ValueError("run_on_mesh needs --mesh or --full-mesh")
    with tempfile.TemporaryDirectory(prefix="train_mesh_") as workdir:
        mp.start_processes(_rank_main, args=(args, mesh_shape, workdir),
                           nprocs=math.prod(mesh_shape[0]), join=True,
                           start_method="spawn")
        with open(os.path.join(workdir, "history.json")) as f:
            return json.load(f)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--full-mesh", action="store_true",
                    help="the production (16, 16) mesh: 256 ranks")
    ap.add_argument("--mesh", type=int, nargs=2, default=None,
                    metavar=("DATA", "MODEL"), help="a (data, model) mesh of ranks")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash at this step (fault-tolerance demo)")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg, shape = build(args)
    if cfg.frontend != "tokens":
        raise SystemExit("the train launcher takes token frontends")
    mesh = _mesh_of(args)
    t_start = time.perf_counter()
    ckpt = CheckpointManager(PmemTier(args.ckpt_dir), f"train/{cfg.name}", keep=2)
    step0 = int(ckpt.latest_step() or 0)
    try:
        if mesh is None:
            train(cfg, shape, AdamWConfig(lr=args.lr, weight_decay=0.0), ckpt,
                  steps=args.steps, checkpoint_every=args.checkpoint_every,
                  fail_at=args.fail_at, compress_grads=args.compress_grads,
                  device=args.device)
    finally:
        ckpt.close()
    if mesh is not None:  # its ranks log, checkpoint and restore themselves
        run_on_mesh(args)
    dt = time.perf_counter() - t_start
    print(f"done: {args.steps - step0} steps in {dt:.1f}s "
          f"({(args.steps - step0) / dt:.2f} steps/s)")


if __name__ == "__main__":
    main()
