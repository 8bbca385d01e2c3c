"""Multi-rank runs for ``tests/test_torch_sharded_mixers.py``, as a script.

    python tests/sharded_mixers_worlds.py reference OUT  # JAX, 4 host devices
    python tests/sharded_mixers_worlds.py port OUT       # gloo worlds of 1, 2, 4

The sharded train step of the configurations whose mixers or FFN the
step cuts beyond attention and the dense MLP: the SSM, RG-LRU and MLA
mixers under TP, and MoE on data axes and expert-parallel.  The test
writes each variant's initial f32 parameters
into ``OUT/init_{variant}.npz``, then runs both sides, each in a
subprocess of its own; every step computes in f32 on both sides (the
cast is patched here, as ``sharded_train_worlds.py`` does).  Each run is
2 steps of the same batches and writes ``{ref,port,one}_{case}.npz``
(losses, grad norms, the whole final parameters, and the first moment
after the first step, the clipped first gradient times ``1 - b1``, leaf
by leaf):

* ``ref_*``: the reference's sharded step on forced host devices
  (``REF_CASES``);
* ``port_*``: the port's sharded step on gloo worlds of 4 and 2 ranks
  (``CASES`` by mesh size), and at world size 1 on a (1, 1) mesh
  (``W1_CASES``);
* ``one_*``: the port's one-process step of each distinct computation
  (:func:`one_key`: the mesh and ``zero1`` do not change it).

The deepseek (4, 1) run also counts, over its MoE layers' global routes,
the entries the capacity drops and those a per-rank route (each rank's
rows alone at its own capacity) would keep or drop otherwise
(``route_*.npz``).  The launcher runs reduced deepseek-v2-lite-16b on
``--mesh 2 1`` with and without a crash (``launch_{clean,crash}.json``).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import sys
from dataclasses import replace

import numpy as np

import sharded_train_worlds as sw

DM, PDM = sw.DM, sw.PDM
#: a capacity factor at which no route drops an entry (top-2 of 8 experts:
#: an expert takes at most one entry a token, so 4 would do, and the a2a
#: path's send buffers need TP)
NO_DROP = 8.0
#: variant -> (arch, fields replaced in the reduced config: "window" as in
#: sharded_train_worlds, "capacity_factor" in the MoE config)
VARIANTS = {
    "mamba2": ("mamba2-2.7b", {}),
    "rg": ("recurrentgemma-9b", {"window": 16}),
    "deepseek": ("deepseek-v2-lite-16b", {}),
    "deepseek_nodrop": ("deepseek-v2-lite-16b", {"capacity_factor": NO_DROP}),
    "dbrx": ("dbrx-132b", {}),
    "dbrx_nodrop": ("dbrx-132b", {"capacity_factor": NO_DROP}),
}
#: case -> (variant, mesh shape, axes, options: zero1, remat, compress,
#: batch, aux: the balance loss's coefficient (default 0.01)).  The
#: expert-parallel cases ("_ep_") run where nothing drops and with no
#: balance loss: the reference's EP paths route each shard's rows on their
#: own, so only there is the one-process step their oracle.
CASES = {
    # on 4 ranks
    "deepseek_d4m1": ("deepseek", (4, 1), DM, {}),
    "deepseek_d2m2": ("deepseek", (2, 2), DM, {}),
    "mamba2_d1m4": ("mamba2", (1, 4), DM, {}),
    "rg_d2m2": ("rg", (2, 2), DM, {}),
    "dbrx_d2m2": ("dbrx", (2, 2), DM, {}),
    "mamba2_d2m2_remat": ("mamba2", (2, 2), DM, {"remat": "full"}),
    "mamba2_d2m2_zero1": ("mamba2", (2, 2), DM, {"zero1": True}),
    "rg_d2m2_compress": ("rg", (2, 2), DM, {"compress": True}),
    # 2 microbatches of 2 rows over 4 data ranks: each rank routes them whole
    "deepseek_d4m1_replicated": ("deepseek", (4, 1), DM, {"batch": 4}),
    "deepseek_p2d2m1": ("deepseek", (2, 2, 1), PDM, {}),
    "deepseek_ep_d2m2": ("deepseek_nodrop", (2, 2), DM, {"aux": 0.0}),
    "deepseek_ep_d1m4": ("deepseek_nodrop", (1, 4), DM, {"aux": 0.0}),
    "dbrx_ep_d2m2": ("dbrx_nodrop", (2, 2), DM, {"aux": 0.0}),
    "dbrx_ep_d1m4": ("dbrx_nodrop", (1, 4), DM, {"aux": 0.0}),
    # on 2 ranks
    "mamba2_d1m2": ("mamba2", (1, 2), DM, {}),
    "rg_d1m2": ("rg", (1, 2), DM, {}),
    "deepseek_d2m1": ("deepseek", (2, 1), DM, {}),
    "deepseek_d2m1_zero1": ("deepseek", (2, 1), DM, {"zero1": True}),
    "deepseek_ep_d1m2": ("deepseek_nodrop", (1, 2), DM, {"aux": 0.0}),
    "dbrx_ep_d1m2": ("dbrx_nodrop", (1, 2), DM, {"aux": 0.0}),
}
#: the reference runs these of CASES
REF_CASES = ("deepseek_d4m1", "deepseek_d2m2", "mamba2_d1m4", "rg_d2m2", "dbrx_d2m2")
#: held to the one-process step: every case but the reference's EP ones,
#: whose per-shard routes drop and balance what one process does not
ONE_CASES = tuple(c for c in CASES if c not in ("deepseek_d2m2", "dbrx_d2m2"))
#: world size 1, a (1, 1) mesh: the sharded step is the one-process one
W1_CASES = {
    "mamba2_w1": ("mamba2", (1, 1), DM, {}),
    "rg_w1": ("rg", (1, 1), DM, {}),
    "deepseek_w1": ("deepseek", (1, 1), DM, {}),
}
#: the case whose routes are counted
ROUTE_CASE = "deepseek_d4m1"
LAUNCH = ["--arch", "deepseek-v2-lite-16b", "--mesh", "2", "1", "--device", "cpu",
          "--steps", "6", "--batch", "4", "--seq", "32", "--microbatches", "2",
          "--checkpoint-every", "3"]


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
    cf = kw.pop("capacity_factor", None)
    if cf is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=cf))
    return replace(cfg, **kw)


def one_key(case: str) -> str:
    """The name of the one-process run ``case`` is held to: its variant and
    the options that change the computation."""
    variant, _, _, opts = {**CASES, **W1_CASES}[case]
    parts = [variant] + [f"{k}{opts[k]}" for k in ("batch", "remat", "compress", "aux")
                         if k in opts]
    return "_".join(str(p) for p in parts)


def _one_specs() -> dict:
    """key -> a case spec of each distinct one-process run."""
    out = {}
    for case in ONE_CASES + tuple(W1_CASES):
        out.setdefault(one_key(case), {**CASES, **W1_CASES}[case])
    return out


# -- the reference ----------------------------------------------------------

def run_reference(out: str, *cases: str) -> None:
    """The reference's runs of ``cases`` (default: every REF_CASES one, each
    in a subprocess of its own, at once: a compile takes ~15 s)."""
    if not cases:
        import subprocess

        procs = [subprocess.Popen([sys.executable, __file__, "reference", out, case])
                 for case in REF_CASES]
        if any(p.wait() for p in procs):
            raise SystemExit("a reference run failed")
        return
    import jax

    devices = np.array(jax.devices())
    assert devices.size == 4, "run with 4 forced host devices"
    for case in cases:
        losses, norms, leaves, mu1 = sw.ref_run(out, CASES[case], devices, make_cfg)
        sw.save_run(out, f"ref_{case}", losses, norms, [0.0] * sw.STEPS, leaves, mu1)


# -- the port ---------------------------------------------------------------

@contextlib.contextmanager
def _counting_routes(variant: str):
    """Within it, each global MoE route also counts [entries dropped,
    entries a per-rank route (each rank's rows at its own capacity) would
    keep or drop otherwise]; yields the running counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe, reduced_for_smoke

    cf = make_cfg(variant, get_config, reduced_for_smoke).moe.capacity_factor
    counts = [0, 0]
    pack = moe._pack_by_group

    def counting(groups, n_groups, capacity, ahead=None):
        res = pack(groups, n_groups, capacity, ahead)
        if ahead is not None:
            keep, gs = res[3], res[1]
            local = pack(groups, n_groups,
                         max(1, math.ceil(groups.numel() / n_groups * cf)))[3]
            counts[0] += int(((gs < n_groups) & ~keep).sum())
            counts[1] += int((keep != local).sum())
        return res

    moe._pack_by_group = counting
    try:
        yield counts
    finally:
        moe._pack_by_group = pack


def _world(rank: int, size: int, out: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch import make_mesh_compat, process_group

    sw._f32_compute()
    with process_group(rank, size, os.path.join(out, f"rdzv{size}"), "cpu"):
        for case, spec in CASES.items():
            if math.prod(spec[1]) != size:
                continue
            mesh = make_mesh_compat(spec[1], spec[2], "cpu")
            if case != ROUTE_CASE:
                res = sw.port_run(out, spec, mesh, make_cfg)
            else:
                with _counting_routes(spec[0]) as counts:
                    res = sw.port_run(out, spec, mesh, make_cfg)
                total = torch.tensor(counts)
                dist.all_reduce(total)
                if rank == 0:
                    sw.save(out, f"route_{case}", dropped=int(total[0]),
                            differ=int(total[1]))
            if rank == 0:
                sw.save_run(out, f"port_{case}", *res)


def _world1(out: str) -> None:
    """World size 1: the (1, 1) mesh's runs."""
    from repro_torch.launch import make_mesh_compat, process_group

    sw._f32_compute()
    with process_group(0, 1, os.path.join(out, "rdzv1"), "cpu"):
        mesh = make_mesh_compat((1, 1), DM, "cpu")
        for case, spec in W1_CASES.items():
            sw.save_run(out, f"port_{case}", *sw.port_run(out, spec, mesh, make_cfg))


def _one(i: int, keys: list, out: str) -> None:
    """The one-process runs of every other key from the ``i``-th."""
    sw._f32_compute()
    specs = _one_specs()
    for key in keys[i::2]:
        sw.save_run(out, f"one_{key}", *sw.port_run(out, specs[key], None, make_cfg))


def _launch(out: str, name: str, extra: list) -> None:
    from repro_torch.launch.train import parse_args, run_on_mesh

    args = parse_args(LAUNCH + extra + ["--ckpt-dir", os.path.join(out, f"launch_{name}")])
    with open(os.path.join(out, f"launch_{name}.json"), "w") as f:
        json.dump(run_on_mesh(args), f)


def run_port(out: str) -> None:
    """Every world at once, the one-process runs in two more processes."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    import torch.multiprocessing as mp

    torch.set_num_threads(1)  # the launcher's threads run here

    worlds = [mp.start_processes(_world, args=(n, out), nprocs=n, join=False,
                                 start_method="spawn") for n in (4, 2)]
    ones = mp.start_processes(_one, args=(sorted(_one_specs()), out), nprocs=2,
                              join=False, start_method="spawn")
    with ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(_launch, out, name, extra)
                for name, extra in (("clean", []), ("crash", ["--fail-at", "5"]))]
        _world1(out)
        for r in runs:
            r.result()
    for world in worlds + [ones]:
        while not world.join():
            pass


if __name__ == "__main__":
    side, folder, *names = sys.argv[1:]
    {"reference": run_reference, "port": run_port}[side](folder, *names)
