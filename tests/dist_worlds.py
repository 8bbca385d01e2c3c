"""Multi-rank runs for ``tests/test_torch_distributed.py``, as a script.

    python tests/dist_worlds.py reference OUT   # the JAX package, 4 host devices
    python tests/dist_worlds.py port OUT        # gloo worlds of 1, 2 and 4 ranks

The test writes the MoE parameters (drawn by the reference) into
``OUT/moe_e{8,6}.npz`` and runs both sides, each in a subprocess of its
own.  Both sides draw every other input from the seeded cases below, run
every case of the file, and write one ``.npz`` per result into ``OUT``:
``ref_*`` from the reference's ``shard_map`` paths on meshes of forced
host devices, ``port_*_r{rank}`` from every rank of the port's worlds.
The reference side must run with ``XLA_FLAGS`` forcing 4 host devices;
the port side spawns each world's ranks (``torch.multiprocessing``,
``spawn``), which meet through a rendezvous file in ``OUT``, so no TCP
port is used.  A rank that fails makes the script exit non-zero.
"""

from __future__ import annotations

import os
import sys
from dataclasses import replace

import numpy as np

VOCAB = 101
#: device_histogram cases: keys, values and keyword arguments of each
HIST_CASES = ("uniform", "zipf", "odd_n", "drop", "spill", "empty")
#: mesh name -> (shape, axes)
MESHES = {
    "d1": ((1,), ("data",)),
    "d1m1": ((1, 1), ("data", "model")),
    "d2": ((2,), ("data",)),
    "d4": ((4,), ("data",)),
    "d2m2": ((2, 2), ("data", "model")),
    "d1m4": ((1, 4), ("data", "model")),
    "d1m2": ((1, 2), ("data", "model")),
}
HIST_MESHES = ("d2", "d4", "d2m2")
#: the cases whose every weight is 1, run again with ``unit_weights=True``
UNIT_CASES = ("uniform", "odd_n", "drop", "empty")
#: the port's worlds: size -> the meshes built over it
WORLDS = {1: ("d1", "d1m1"), 2: ("d1m2", "d2"), 4: ("d4", "d2m2", "d1m4")}
#: MoE cases on the (2, 2) mesh: (path, capacity factor, zero1)
MOE_CASES = tuple((path, cf, zero1) for path in ("a2a", "gather")
                  for cf in (16.0, 0.5) for zero1 in (False, True))
#: the expert-parallel paths under autograd: (mesh, path, zero1), where
#: nothing drops; the loss is ``sum(out * moe_grad_weights(...))``
GRAD_CASES = tuple((mesh, path, zero1) for mesh in ("d1m2", "d2m2")
                   for path in ("a2a", "gather") for zero1 in (False, True))
#: moe_apply's dispatch: name -> (mesh, T, experts); the reference picks
#: a2a, gather, dense (TP 1) and dense (TP does not divide the experts)
DISPATCH_CASES = {"a2a": ("d2m2", 8, 8), "gather": ("d2m2", 3, 8),
                  "tp1": ("d1m1", 8, 8), "indivisible": ("d1m4", 8, 6)}
MOE_B = 4
ARCH = "deepseek-v2-lite-16b"


def hist_case(case: str):
    """(keys, values, keyword arguments) of a device_histogram case."""
    rng = np.random.default_rng(HIST_CASES.index(case))
    n = {"odd_n": 4 * 97 + 3, "empty": 0}.get(case, 4096)
    if case in ("zipf", "drop", "spill"):
        keys = (rng.zipf(1.3, n) % VOCAB).astype(np.int32)
    else:
        keys = rng.integers(-1, VOCAB, n).astype(np.int32)
    if case in ("zipf", "spill"):
        vals = rng.random(n).astype(np.float32)
    else:
        vals = np.ones(n, np.int32)
    kw = {"capacity_factor": 0.05 if case in ("drop", "spill") else 4.0}
    return keys, vals, kw, case == "spill"


def shard(a: np.ndarray, ndev: int, i: int) -> np.ndarray:
    """Rank ``i``'s shard: ceil(n / ndev) each, the last ones shorter."""
    n_local = -(-a.shape[0] // ndev)
    return a[i * n_local:(i + 1) * n_local]


def moe_x(T: int, d_model: int) -> np.ndarray:
    return np.random.default_rng(100 + T).standard_normal(
        (MOE_B, T, d_model)).astype(np.float32)


def moe_grad_weights(T: int, d_model: int) -> np.ndarray:
    """The fixed weights of the gradient cases' loss, one per output."""
    return np.random.default_rng(200 + T).standard_normal(
        (MOE_B, T, d_model)).astype(np.float32)


def flatten(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflatten(flat) -> dict:
    tree: dict = {}
    for key in flat:
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    return tree


def save(folder: str, name: str, **arrays) -> None:
    np.savez(os.path.join(folder, name + ".npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})


# -- the reference ----------------------------------------------------------

def run_reference(out: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_config
    from repro.core import device_histogram
    from repro.models import moe, reduced_for_smoke
    from repro.storage import DramTier

    devices = np.array(jax.devices())
    assert devices.size == 4, "run with 4 forced host devices"

    def mesh_of(name):
        shape, axes = MESHES[name]
        n = int(np.prod(shape))
        return Mesh(devices[:n].reshape(shape), axes)

    for m in HIST_MESHES:
        mesh = mesh_of(m)
        ndev = mesh.shape["data"]
        for case in HIST_CASES:
            keys, vals, kw, spill = hist_case(case)
            # the reference's shard_map takes whole shards: pad with -1
            n_pad = ndev * -(-keys.shape[0] // ndev)
            pk = np.full(n_pad, -1, np.int32)
            pk[:keys.shape[0]] = keys
            pv = np.zeros(n_pad, vals.dtype)
            pv[:vals.shape[0]] = vals
            res = device_histogram(jnp.asarray(pk), jnp.asarray(pv), mesh, "data",
                                   vocab=VOCAB, spill_tier=DramTier() if spill else None,
                                   **kw)
            save(out, f"ref_hist_{m}_{case}", counts=res.counts, dropped=res.dropped,
                 shuffled_bytes=res.shuffled_bytes, buffer_bytes=res.buffer_bytes,
                 spilled=res.spilled, spilled_bytes=res.spilled_bytes)

    base = reduced_for_smoke(get_config(ARCH))
    params = {E: jax.tree_util.tree_map(
        jnp.asarray, unflatten(dict(np.load(os.path.join(out, f"moe_e{E}.npz")))))
        for E in (8, 6)}
    mesh = mesh_of("d2m2")
    for path, cf, zero1 in MOE_CASES:
        cfg = replace(base, moe=replace(base.moe, capacity_factor=cf))
        fn = moe.moe_apply_a2a if path == "a2a" else moe.moe_apply_gather
        # jitted, as the reference's own steps run it (an eager shard_map
        # dispatches op by op)
        y, aux = jax.jit(fn, static_argnums=(2, 3, 4, 5, 6))(
            params[8], jnp.asarray(moe_x(8, cfg.d_model)), cfg, mesh, ("data",),
            "model", zero1)
        save(out, f"ref_moe_{path}_{cf}_{zero1}", out=y, aux=aux)
    for name, (m, T, E) in DISPATCH_CASES.items():
        cfg = replace(base, moe=replace(base.moe, n_experts=E, capacity_factor=16.0))
        called = _record_paths(moe)
        y, aux = jax.jit(moe.moe_apply, static_argnums=(2, 3, 4, 5))(
            params[E], jnp.asarray(moe_x(T, cfg.d_model)), cfg, mesh_of(m),
            ("data",), "model")
        save(out, f"ref_dispatch_{name}", out=y, aux=aux, path=called[0])


def _record_paths(module) -> list:
    """Wrap ``module``'s three apply paths so that a call records its
    name (``moe_apply`` looks them up in the module when it runs)."""
    called: list = []
    for name in ("moe_apply_dense", "moe_apply_a2a", "moe_apply_gather"):
        fn = getattr(module, name)
        fn = getattr(fn, "__wrapped__", fn)

        def wrapper(*a, _fn=fn, _name=name, **kw):
            called.append(_name)
            return _fn(*a, **kw)

        wrapper.__wrapped__ = fn
        setattr(module, name, wrapper)
    return called


# -- the port ---------------------------------------------------------------

def _world(rank: int, world_size: int, out: str) -> None:
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.core import device_histogram
    from repro_torch.launch import make_ctx, make_mesh_compat, make_production_mesh
    from repro_torch.launch.mesh import process_group
    from repro_torch.models import (
        ShardCtx, constrain, decode_step, forward, init_cache, init_params,
        logits_fn, model_defs, moe, reduced_for_smoke, shard_moe_params,
    )
    from repro_torch.models.convert import to_tensor
    from repro_torch.storage import DramTier

    torch.set_num_threads(1)  # one core a rank, as OMP_NUM_THREADS asks
    tag = f"r{rank}"
    with process_group(rank, world_size, os.path.join(out, f"rdzv{world_size}"),
                       "cpu"):
        meshes = {m: make_mesh_compat(*MESHES[m], "cpu") for m in WORLDS[world_size]}
        for m, mesh in meshes.items():
            if m not in HIST_MESHES + ("d1",):
                continue
            ndev = MESHES[m][0][0]
            me = mesh.get_local_rank("data")
            for case in HIST_CASES:
                keys, vals, kw, spill = hist_case(case)
                res = device_histogram(
                    shard(keys, ndev, me), shard(vals, ndev, me), vocab=VOCAB,
                    spill_tier=DramTier() if spill else None, mesh=mesh, **kw)
                save(out, f"port_hist_{m}_{case}_{tag}", counts=res.counts,
                     dropped=res.dropped, shuffled_bytes=res.shuffled_bytes,
                     buffer_bytes=res.buffer_bytes, spilled=res.spilled,
                     spilled_bytes=res.spilled_bytes)
                if case in UNIT_CASES:  # each owner counts with bucket_histogram
                    res = device_histogram(
                        shard(keys, ndev, me), shard(vals, ndev, me), vocab=VOCAB,
                        mesh=mesh, unit_weights=True, **kw)
                    save(out, f"port_hist_unit_{m}_{case}_{tag}", counts=res.counts,
                         dropped=res.dropped, shuffled_bytes=res.shuffled_bytes,
                         buffer_bytes=res.buffer_bytes, spilled=res.spilled,
                         spilled_bytes=res.spilled_bytes)
                if m == "d1":  # today's one-device call on the same keys
                    res = device_histogram(keys, vals, 1, vocab=VOCAB, device="cpu",
                                           spill_tier=DramTier() if spill else None,
                                           **kw)
                    save(out, f"port_hist1_{case}", counts=res.counts,
                         dropped=res.dropped, shuffled_bytes=res.shuffled_bytes,
                         buffer_bytes=res.buffer_bytes, spilled=res.spilled,
                         spilled_bytes=res.spilled_bytes)

        base = reduced_for_smoke(get_config(ARCH))
        params = {E: {k: to_tensor(v) if not isinstance(v, dict)
                      else {kk: to_tensor(vv) for kk, vv in v.items()}
                      for k, v in unflatten(dict(np.load(
                          os.path.join(out, f"moe_e{E}.npz")))).items()}
                  for E in (8, 6)}
        if "d2m2" in meshes:
            mesh = meshes["d2m2"]
            for path, cf, zero1 in MOE_CASES:
                cfg = replace(base, moe=replace(base.moe, capacity_factor=cf))
                fn = moe.moe_apply_a2a if path == "a2a" else moe.moe_apply_gather
                local = moe.shard_params(params[8], mesh, ("data",), "model", zero1)
                with torch.no_grad():
                    y, aux = fn(local, torch.from_numpy(moe_x(8, cfg.d_model)), cfg,
                                mesh, ("data",), "model", zero1)
                save(out, f"port_moe_{path}_{cf}_{zero1}_{tag}", out=y, aux=aux,
                     w_gate_shape=local["w_gate"].shape,
                     router_shape=local["router"].shape)
            # constrain: a DTensor is redistributed by the reference's rules
            ctx = make_ctx(mesh)
            x = torch.arange(4 * 6 * 5, dtype=torch.float32).reshape(4, 6, 5)
            dx = constrain(distribute_tensor(x, mesh, [Replicate(), Replicate()]),
                           ctx, "b", "tp", "tp")
            odd = constrain(distribute_tensor(x[:3], mesh, [Replicate(), Replicate()]),
                            ctx, "b", "tp")
            save(out, f"port_constrain_{tag}",
                 placements=[str(p) for p in dx.placements],
                 local_shape=dx.to_local().shape, full=dx.full_tensor(),
                 odd_placements=[str(p) for p in odd.placements],
                 plain_same=constrain(x, ctx, "b") is x,
                 expect=[str(Shard(0)), str(Shard(1))])
            # a reduced model's forward and decode with the MoE layers
            # expert-parallel over the mesh
            mcfg = replace(base, moe=replace(base.moe, capacity_factor=16.0))
            tp = init_params(model_defs(mcfg), torch.Generator().manual_seed(0), "cpu",
                             dtype=torch.float32)
            sp = shard_moe_params(tp, mcfg, ctx)
            tokens = torch.from_numpy(np.random.default_rng(5).integers(
                0, mcfg.vocab, (2, 8)).astype(np.int32))
            with torch.no_grad():
                h, _ = forward(sp, mcfg, {"tokens": tokens}, ctx=ctx)
                cache = init_cache(mcfg, 2, 4, dtype=torch.float32, device="cpu")
                steps = []
                for t in range(4):
                    lg, cache = decode_step(sp, mcfg, tokens[:, t:t + 1], cache, t,
                                            ctx=ctx)
                    steps.append(lg)
            save(out, f"port_model_{tag}", logits=logits_fn(tp, mcfg, h),
                 decode=torch.stack(steps, 1))
        for m, path, zero1 in GRAD_CASES:
            if m not in meshes:
                continue
            cfg = replace(base, moe=replace(base.moe, capacity_factor=16.0))
            fn = moe.moe_apply_a2a if path == "a2a" else moe.moe_apply_gather
            local = moe.shard_params(params[8], meshes[m], ("data",), "model", zero1)
            local = {k: ({kk: vv.clone().requires_grad_() for kk, vv in v.items()}
                         if isinstance(v, dict) else v.clone().requires_grad_())
                     for k, v in local.items()}
            x = torch.from_numpy(moe_x(8, cfg.d_model)).requires_grad_()
            y, _ = fn(local, x, cfg, meshes[m], ("data",), "model", zero1)
            (y * torch.from_numpy(moe_grad_weights(8, cfg.d_model))).sum().backward()
            grads = {f"{k}/{kk}" if isinstance(v, dict) else k:
                     (vv if isinstance(v, dict) else v).grad
                     for k, v in local.items()
                     for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)])}
            save(out, f"port_moe_grad_{m}_{path}_{zero1}_{tag}", x=x.grad, **grads)
        for name, (m, T, E) in DISPATCH_CASES.items():
            if m not in meshes:
                continue
            cfg = replace(base, moe=replace(base.moe, n_experts=E, capacity_factor=16.0))
            called = _record_paths(moe)
            with torch.no_grad():
                y, aux = moe.moe_apply(
                    moe.shard_params(params[E], meshes[m]),
                    torch.from_numpy(moe_x(T, cfg.d_model)), cfg, meshes[m])
            save(out, f"port_dispatch_{name}_{tag}", out=y, aux=aux, path=called[0])
        # a mesh that is not the world's size is refused, naming both
        errors = []
        for make in (lambda: make_mesh_compat((world_size + 1,), ("data",), "cpu"),
                     lambda: make_production_mesh(device_type="cpu")):
            try:
                make()
                errors.append("")
            except ValueError as e:
                errors.append(str(e))
        ctx = ShardCtx(meshes[WORLDS[world_size][-1]])
        sizes = (ctx.dp_size(), ctx.tp_size())
    save(out, f"port_world{world_size}_{tag}", errors=errors, sizes=sizes,
         left=torch.distributed.is_initialized())


def run_port(out: str) -> None:
    import torch
    import torch.multiprocessing as mp

    torch.set_num_threads(1)

    for size in WORLDS:
        mp.start_processes(_world, args=(size, out), nprocs=size, join=True,
                           start_method="spawn")


if __name__ == "__main__":
    side, out = sys.argv[1], sys.argv[2]
    {"reference": run_reference, "port": run_port}[side](out)
