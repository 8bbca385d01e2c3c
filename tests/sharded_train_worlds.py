"""Multi-rank runs for ``tests/test_torch_sharded_train.py``, as a script.

    python tests/sharded_train_worlds.py reference OUT  # JAX, 4 host devices
    python tests/sharded_train_worlds.py port OUT       # gloo worlds of 1, 2, 4

The test writes each configuration's initial f32 parameters (drawn by the
reference) into ``OUT/init_{variant}.npz`` (leaves in the reference's
order) and a reference checkpoint under ``OUT/refckpt``, then runs both
sides, each in a subprocess of its own.  Every step computes in f32 on
both sides: the reference's ``launch.steps._cast_tree`` and the port's
``COMPUTE_DTYPE`` are patched here, in the subprocess, not in the
packages.  Each run is 2 steps of the same batches; it writes its losses,
grad norms, final parameters and the first moment after the first step
(whole, in leaf order) as ``{ref,port,one}_{case}.npz``:

* ``ref_*``: the reference's sharded ``make_train_step`` on a mesh of
  forced host devices (``REF_CASES``);
* ``port_*``: the port's sharded step on a gloo world of 4 ranks (every
  case of ``CASES``), and at world size 1 on a (1, 1) mesh (``W1_CASES``);
* ``one_*``: the port's one-process step from the same state.

The world of 2 records the launcher on a mesh: ``--mesh 2 1`` runs with
and without a crash (``launch_{clean,crash}.json``), the
sharded ``train`` loop's final parameters beside its last checkpoint's
one-process restore, and checkpoints restored on other meshes.  Ranks
meet through rendezvous files in ``OUT``; a rank that fails makes the
script exit non-zero.
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import replace

import numpy as np

SEQ, BATCH, MICROBATCHES, STEPS = 32, 8, 2, 2
LR = 3e-3
DM, PDM = ("data", "model"), ("pod", "data", "model")
#: configuration variants: name -> (arch, fields replaced in the reduced
#: config; "window" shortens every local layer's window to mask at SEQ).
#: qwen16 (16 heads over 2 kv heads) and qwen48 (48 over 6) shard heads over
#: TP with the kv projections replicated (a rank's q heads share one kv
#: head; split a kv group unevenly), mha16 shards the kv heads too; the
#: reduced configs (4 heads) shard head_dim, as the reference's rule says.
VARIANTS = {
    "qwen": ("qwen2.5-3b", {}),
    "qwen16": ("qwen2.5-3b", {"n_heads": 16, "n_kv_heads": 2, "head_dim": 8}),
    "qwen48": ("qwen2.5-3b", {"n_heads": 48, "n_kv_heads": 6, "head_dim": 4}),
    "mha16": ("qwen2.5-3b", {"n_heads": 16, "n_kv_heads": 16, "head_dim": 4}),
    "gemma2": ("gemma2-9b", {"window": 16}),
    "rg": ("recurrentgemma-9b", {"window": 16}),
    "mamba2": ("mamba2-2.7b", {}),
}
#: case -> (variant, mesh shape, axes, options: zero1, remat, compress, uneven,
#: batch: a global batch other than BATCH)
CASES = {
    "qwen_d2m2": ("qwen", (2, 2), DM, {}),
    "qwen_d2m2_zero1": ("qwen", (2, 2), DM, {"zero1": True}),
    "qwen_d4m1": ("qwen", (4, 1), DM, {}),
    # 2 microbatches of 2 rows over 4 data ranks: each rank runs them whole
    "qwen_d4m1_replicated": ("qwen", (4, 1), DM, {"batch": 4}),
    "qwen_d1m4": ("qwen", (1, 4), DM, {}),
    "qwen16_d1m4": ("qwen16", (1, 4), DM, {}),
    "qwen48_d1m4": ("qwen48", (1, 4), DM, {}),
    "mha16_d1m4": ("mha16", (1, 4), DM, {}),
    "qwen_p2d2m1": ("qwen", (2, 2, 1), PDM, {}),
    "qwen_d2m2_remat": ("qwen", (2, 2), DM, {"remat": "full"}),
    "qwen_d2m2_zero1_remat": ("qwen", (2, 2), DM, {"zero1": True, "remat": "full"}),
    "qwen_d2m2_compress": ("qwen", (2, 2), DM, {"compress": True}),
    "qwen_d2m2_uneven": ("qwen", (2, 2), DM, {"uneven": True}),
    "gemma2_d2m2": ("gemma2", (2, 2), DM, {}),
    "rg_d4m1": ("rg", (4, 1), DM, {}),
    "mamba2_d4m1": ("mamba2", (4, 1), DM, {}),
}
#: the reference runs these of CASES
REF_CASES = ("qwen_d2m2", "qwen_d2m2_zero1", "mamba2_d4m1")
#: world size 1, a (1, 1) mesh: the sharded step is the one-process one
W1_CASES = {
    "qwen_w1": ("qwen", (1, 1), DM, {}),
    "qwen_w1_zero1": ("qwen", (1, 1), DM, {"zero1": True, "remat": "full"}),
    "qwen_w1_compress": ("qwen", (1, 1), DM, {"compress": True}),
}
LAUNCH = ["--arch", "qwen2.5-3b", "--mesh", "2", "1", "--device", "cpu",
          "--steps", "8", "--batch", "4", "--seq", "32", "--microbatches", "2",
          "--checkpoint-every", "4", "--compress-grads"]


def make_cfg(variant: str, get_config, reduced):
    """The reduced configuration of ``variant`` in either package."""
    arch, kw = VARIANTS[variant]
    cfg = reduced(get_config(arch))
    kw = dict(kw)
    window = kw.pop("window", None)
    if window is not None:
        cfg = replace(cfg, pattern=tuple(
            replace(b, window=window) if b.mixer == "local" else b
            for b in cfg.pattern))
    return replace(cfg, **kw)


def shape_kw(opts: dict) -> dict:
    return dict(name="t", kind="train", seq_len=SEQ,
                global_batch=opts.get("batch", BATCH), microbatches=MICROBATCHES, q_chunk=16, kv_chunk=16, loss_chunk=16,
                remat=opts.get("remat", "none"))


def batch_of(make_batch, pipe, step: int, opts: dict) -> dict:
    """The step's batch; "uneven" makes most labels of the first data
    rank's rows (rows 0-1 of each microbatch of 4 at data 2) -100."""
    batch = {k: np.array(v) for k, v in make_batch(pipe, step).items()}
    if opts.get("uneven"):
        per = opts.get("batch", BATCH) // MICROBATCHES
        for i in range(MICROBATCHES):
            batch["labels"][i * per:i * per + per // 2, :SEQ - 4] = -100
    return batch


def save(out: str, name: str, **arrays) -> None:
    np.savez(os.path.join(out, name + ".npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})


def save_run(out: str, name: str, losses, norms, errs, leaves, mu1=()) -> None:
    save(out, name, losses=losses, grad_norms=norms, compression_err=errs,
         **{f"p{i}": x for i, x in enumerate(leaves)},
         **{f"m{i}": x for i, x in enumerate(mu1)})


def init_leaves(out: str, variant: str) -> list:
    with np.load(os.path.join(out, f"init_{variant}.npz")) as f:
        return [f[f"p{i}"] for i in range(len(f.files))]


# -- the reference ----------------------------------------------------------

def ref_run(out: str, spec, devices, make=make_cfg):
    """2 steps of ``spec`` (a CASES entry) in the reference's sharded step on
    a mesh of ``devices``, computing in f32; returns (losses, grad norms,
    final leaves, the first moment's leaves after the first step).  ``make``
    makes the configuration of ``spec``'s variant."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_config
    from repro.data.pipeline import PipelineConfig, make_batch
    from repro.launch import steps
    from repro.models import ShapeConfig, abstract_params, model_defs, reduced_for_smoke
    from repro.optim.adamw import AdamWConfig, adamw_init

    steps._cast_tree = lambda tree, dtype: tree  # f32 compute, as the port's
    variant, mesh_shape, axes, opts = spec
    cfg = make(variant, get_config, reduced_for_smoke)
    mesh = Mesh(devices.reshape(mesh_shape), axes)
    treedef = jax.tree_util.tree_structure(abstract_params(model_defs(cfg)))
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(x) for x in init_leaves(out, variant)])
    fn = steps.make_train_step(cfg, ShapeConfig(**shape_kw(opts)), mesh,
                               AdamWConfig(lr=LR, weight_decay=0.0),
                               aux_coef=opts.get("aux", 0.01),
                               zero1=opts.get("zero1", False)).jitted(mesh)
    opt = adamw_init(params)
    pipe = PipelineConfig(vocab=cfg.vocab, seq_len=SEQ,
                          global_batch=opts.get("batch", BATCH))
    losses, norms, mu1 = [], [], None
    for step in range(STEPS):
        batch = {k: jnp.asarray(v)
                 for k, v in batch_of(make_batch, pipe, step, opts).items()}
        params, opt, m = fn(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if mu1 is None:
            mu1 = [np.asarray(x) for x in jax.tree_util.tree_leaves(opt.mu)]
    return losses, norms, [np.asarray(x) for x in jax.tree_util.tree_leaves(params)], mu1


def run_reference(out: str) -> None:
    import jax

    devices = np.array(jax.devices())
    assert devices.size == 4, "run with 4 forced host devices"
    for case in REF_CASES:
        losses, norms, leaves, mu1 = ref_run(out, CASES[case], devices)
        save_run(out, f"ref_{case}", losses, norms, [0.0] * STEPS, leaves, mu1)


# -- the port ---------------------------------------------------------------

def port_run(out: str, spec, mesh, make=make_cfg):
    """2 steps of ``spec`` (a CASES entry) on ``mesh`` (None: one process);
    returns (losses, grad norms, compression errors, whole final leaves,
    whole first moments after the first step) on every rank.  ``make`` as
    for :func:`ref_run`."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, make_batch
    from repro_torch.launch import make_train_step
    from repro_torch.launch.train import _skeleton
    from repro_torch.models import ShapeConfig, from_jax_params, reduced_for_smoke
    from repro_torch.optim import AdamWConfig, adamw_init, ef_init
    from repro_torch.parallel.sharding import param_pspecs, shard_tree, unshard_tree
    from repro_torch.tree import tree_leaves, tree_unflatten

    variant, _, _, opts = spec
    cfg = make(variant, get_config, reduced_for_smoke)
    params = from_jax_params(tree_unflatten(_skeleton(cfg)[0], init_leaves(out, variant)),
                             cfg, "cpu")
    specs = None if mesh is None else param_pspecs(cfg, mesh)
    if specs is not None:
        params = shard_tree(params, specs, mesh)
    opt = adamw_init(params)
    compress = opts.get("compress", False)
    ef = ef_init(params) if compress else None
    fn = make_train_step(cfg, ShapeConfig(**shape_kw(opts)),
                         AdamWConfig(lr=LR, weight_decay=0.0),
                         aux_coef=opts.get("aux", 0.01), compress_grads=compress,
                         device="cpu", mesh=mesh,
                         zero1=mesh is not None and opts.get("zero1", False))
    pipe = PipelineConfig(vocab=cfg.vocab, seq_len=SEQ,
                          global_batch=opts.get("batch", BATCH))
    losses, norms, errs, mu1 = [], [], [], None
    for step in range(STEPS):
        res = fn(params, opt, batch_of(make_batch, pipe, step, opts),
                 *((ef,) if compress else ()))
        params, opt, m = res[:3]
        if compress:
            ef = res[3]
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        errs.append(float(m.get("compression_err", torch.zeros(()))))
        if mu1 is None:
            mu1 = opt.mu if specs is None else unshard_tree(opt.mu, specs, mesh)
            mu1 = [x.clone().numpy() for x in tree_leaves(mu1)]
    if specs is not None:
        params = unshard_tree(params, specs, mesh)
    return losses, norms, errs, [x.numpy() for x in tree_leaves(params)], mu1


def _f32_compute() -> None:
    import torch

    from repro_torch.launch import steps
    torch.set_num_threads(1)
    steps.COMPUTE_DTYPE = torch.float32


def _world4(rank: int, out: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch import make_mesh_compat, process_group

    _f32_compute()
    with process_group(rank, 4, os.path.join(out, "rdzv4"), "cpu"):
        for case, spec in CASES.items():
            mesh = make_mesh_compat(spec[1], spec[2], "cpu")
            res = port_run(out, spec, mesh)
            if dist.get_rank() == 0:
                save_run(out, f"port_{case}", *res)


def _world2(rank: int, out: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import make_mesh_compat, process_group
    from repro_torch.launch.train import restore_state, train
    from repro_torch.models import ShapeConfig, reduced_for_smoke
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel.sharding import param_pspecs, unshard_tree
    from repro_torch.storage import CheckpointManager, PmemTier
    from repro_torch.tree import tree_leaves

    _f32_compute()
    shape = ShapeConfig(**shape_kw({}))
    with process_group(rank, 2, os.path.join(out, "rdzv2"), "cpu"):
        cfg = reduced_for_smoke(get_config("qwen2.5-3b"))
        restored = {}
        # the launcher's (2, 1) checkpoint on a (1, 2) mesh, the reference's
        # on (2, 1); unsharded here, compared with one-process restores
        for name, ckpt_dir, prefix, mesh_shape in (
                ("launch", "launch_crash", f"train/{cfg.name}", (1, 2)),
                ("ref", "refckpt", "train/x", (2, 1))):
            mesh = make_mesh_compat(mesh_shape, DM, "cpu")
            ckpt = CheckpointManager(PmemTier(os.path.join(out, ckpt_dir)), prefix)
            try:
                params, opt = restore_state(ckpt, cfg, "cpu", mesh=mesh)
            finally:
                ckpt.close()
            specs = param_pspecs(cfg, mesh)
            restored[name] = ([x.numpy() for x in tree_leaves(unshard_tree(
                params, specs, mesh))] + [x.numpy() for x in tree_leaves(unshard_tree(
                    [opt.mu, opt.nu], [specs, specs], mesh))] + [opt.step.numpy()])
        # the sharded loop's own final state against its last checkpoint
        mesh = make_mesh_compat((2, 1), DM, "cpu")
        ckpt = CheckpointManager(PmemTier(os.path.join(out, "loop")), "t", keep=2)
        try:
            res = train(cfg, shape, AdamWConfig(lr=LR, weight_decay=0.0), ckpt,
                        steps=4, checkpoint_every=4, compress_grads=True,
                        device="cpu", log=lambda s: None, mesh=mesh)
        finally:
            ckpt.close()
        final = unshard_tree(res["params"], param_pspecs(cfg, mesh), mesh)
        dist.barrier()
        if rank == 0:
            ckpt = CheckpointManager(PmemTier(os.path.join(out, "loop")), "t")
            try:
                one, _ = restore_state(ckpt, cfg, "cpu")
                state = ckpt.restore()
            finally:
                ckpt.close()
            for name, leaves in restored.items():
                save(out, f"port_restored_{name}", **{f"p{i}": x for i, x in
                                                      enumerate(leaves)})
            save(out, "port_loop", equal=[torch.equal(a, b) for a, b in zip(
                tree_leaves(final), tree_leaves(one))],
                 keys=sorted(state), n_ef=len(state.get("ef", [])))


def _world1(out: str) -> None:
    """World size 1 in this process: the (1, 1) mesh's runs and the
    one-process runs of every case."""
    from repro_torch.launch import make_mesh_compat, process_group

    _f32_compute()
    with process_group(0, 1, os.path.join(out, "rdzv1"), "cpu"):
        for case, spec in W1_CASES.items():
            save_run(out, f"port_{case}",
                     *port_run(out, spec, make_mesh_compat((1, 1), DM, "cpu")))
    for case, spec in {**CASES, **W1_CASES}.items():
        save_run(out, f"one_{case}", *port_run(out, spec, None))


def _launch(out: str, name: str, extra: list) -> None:
    from repro_torch.launch.train import parse_args, run_on_mesh

    args = parse_args(LAUNCH + extra + ["--ckpt-dir", os.path.join(out, f"launch_{name}")])
    with open(os.path.join(out, f"launch_{name}.json"), "w") as f:
        json.dump(run_on_mesh(args), f)


def run_port(out: str) -> None:
    """The worlds at once where nothing orders them: the world of 2 reads
    the launcher's checkpoints."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    import torch.multiprocessing as mp

    torch.set_num_threads(1)  # the launcher's threads run here

    world4 = mp.start_processes(_world4, args=(out,), nprocs=4, join=False,
                                start_method="spawn")
    with ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(_launch, out, name, extra)
                for name, extra in (("clean", []), ("crash", ["--fail-at", "6"]))]
        for r in runs:
            r.result()
    world2 = mp.start_processes(_world2, args=(out,), nprocs=2, join=False,
                                start_method="spawn")
    _world1(out)
    for world in (world2, world4):
        while not world.join():
            pass


if __name__ == "__main__":
    side, folder = sys.argv[1], sys.argv[2]
    {"reference": run_reference, "port": run_port}[side](folder)
