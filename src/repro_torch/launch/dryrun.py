"""Multi-pod dry run on the H100: trace every (arch × shape × mesh) cell
as one rank of a fake production world.

The port of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell's step at 256/512 devices; here the step itself, the
code the card runs, runs once as rank 0 of a fake world of 256 or 512
ranks (``launch.mesh.fake_world``) on fake tensors: every tensor and
collective the step makes on rank 0 is seen, no memory is allocated and
no kernel launched.  For each cell this shows, without a cluster:

  * the sharding is coherent at 256/512 ranks (every rank's block of
    every parameter, batch and cache divides, and every collective's
    shapes agree),
  * the memory plan: the rank's arguments plus the high-water mark of
    the storage the step makes, against the card's 80 GB,
  * and its roofline terms on the H100 (``roofline.derive`` from
    ``cost_analysis.CostCounter``'s counts).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch.json

Fake tensors take the device the step would run on: the card by default
(a CUDA build of torch; the kernel wrappers see fake ``cuda`` tensors,
as on the card), ``--device cpu`` on a CPU-only build.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, shapes_for, skip_reason
from repro_torch.launch import roofline as rl
from repro_torch.launch.cost_analysis import CostCounter, ModuleCosts
from repro_torch.launch.mesh import fake_world, make_mesh_compat, production_mesh_shape
from repro_torch.launch.steps import make_step
from repro_torch.models import ModelConfig, ShapeConfig, init_cache, model_defs
from repro_torch.models.param import leaf_dtype, tree_map_defs
from repro_torch.optim.adamw import adamw_init
from repro_torch.parallel.sharding import (
    batch_entry, cache_pspecs, input_specs, mesh_axes, mesh_shape, param_pspecs,
    shard_tree)
from repro_torch.tree import tree_leaves

__all__ = ["VARIANT_TOKENS", "main", "model_flops", "run_cell", "storage_bytes", "trace"]

#: §Perf hillclimb variants — '+'-separable tokens applied to a cell.
#:   pad-heads : dead-head padding so attention shards on heads (exact fn)
#:   tp4/tp8   : reshape the same 256-card pod to (64,4)/(32,8) — smaller
#:               TP degree -> per-device activation psums shrink with the
#:               larger data axis
#:   no-fsdp   : inference params TP-only (no per-layer ZeRO gathers);
#:               only valid when the bf16 params fit HBM without FSDP
#:   mb<k>     : override gradient-accumulation microbatches
VARIANT_TOKENS = ("pad-heads", "tp4", "tp8", "no-fsdp")


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _apply_variant(cfg: ModelConfig, shape: ShapeConfig, multi_pod: bool,
                   variant: str):
    """(cfg, shape, (mesh shape, axes), step keywords) of ``variant``'s
    tokens, as the reference parses them; an unknown token raises
    ``ValueError``."""
    step_kw: Dict[str, Any] = {}
    mesh = production_mesh_shape(multi_pod)
    for tok in [t for t in (variant or "").split("+") if t]:
        if tok == "pad-heads":
            cfg = dataclasses.replace(cfg, pad_heads=True)
        elif tok in ("tp1", "tp2", "tp4", "tp8"):
            if multi_pod:
                raise ValueError("tp reshape defined for single pod")
            tp = int(tok[2:])
            mesh = ((256 // tp, tp), ("data", "model"))
        elif tok == "no-fsdp":
            step_kw["param_fsdp"] = False
        elif tok == "zero1":
            step_kw["zero1"] = True
        elif tok == "remat-save":
            shape = dataclasses.replace(shape, remat="save_block_out")
        elif tok == "int8-cache":
            step_kw["quant_cache"] = True
        elif tok.startswith("mb"):
            shape = dataclasses.replace(shape, microbatches=int(tok[2:]))
        else:
            raise ValueError(f"unknown variant token {tok!r}")
    return cfg, shape, mesh, step_kw


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS: 6·N_active·D tokens for train (fwd+bwd), 2·N_active·D
    for single forward/prefill, 2·N_active per token for decode."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    # matmul-active params: embedding gather contributes no FLOPs
    n_active = cfg.active_params()
    if cfg.frontend in ("tokens", "tokens+patches"):
        n_active -= cfg.vocab * cfg.d_model
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens


def _params(cfg: ModelConfig, dtype: Optional[torch.dtype], device) -> Any:
    """Uninitialised whole parameters of ``cfg``: each leaf in ``dtype``
    (None: its own), f32 leaves f32."""
    return tree_map_defs(lambda pd: torch.empty(pd.shape, dtype=leaf_dtype(pd, dtype),
                                                device=device), model_defs(cfg))


def _stand_ins(cfg: ModelConfig, shape: ShapeConfig, mesh, step_kw: dict,
               device) -> Tuple[Any, ...]:
    """The step's arguments on this rank of ``mesh`` (None: one card),
    uninitialised: the train step's f32 master shards, their AdamW state
    and the whole batch; the serving steps' weight shards (TP-only without
    ``param_fsdp``), the rank's block of rows, and for decode the cache's
    blocks at its last position."""
    fsdp = Ellipsis if step_kw.get("param_fsdp", True) else None

    def cut(tree, specs):
        return tree if mesh is None else shard_tree(tree, specs(), mesh)

    if shape.kind == "train":
        params = cut(_params(cfg, torch.float32, device),
                     lambda: param_pspecs(cfg, mesh))
        batch = {k: torch.empty(s.shape, dtype=s.dtype, device=device)
                 for k, s in input_specs(cfg, shape).items()}
        return params, adamw_init(params), batch
    params = cut(_params(cfg, None, device), lambda: param_pspecs(cfg, mesh, fsdp))
    B = rows = shape.global_batch
    if mesh is not None and batch_entry(mesh, B) is not None:
        rows = B // math.prod(mesh_shape(mesh)[a] for a in mesh_axes(mesh)[0])
    batch = {k: torch.empty((rows,) + tuple(s.shape[1:]), dtype=s.dtype, device=device)
             for k, s in input_specs(cfg, shape).items()}
    if shape.kind == "prefill":
        return params, batch
    quant = step_kw.get("quant_cache", False)
    cache = cut(init_cache(cfg, B, shape.seq_len, torch.bfloat16, quant_attn=quant,
                           device=device),
                lambda: cache_pspecs(cfg, shape, mesh, quant))
    return params, batch["tokens"], cache, shape.seq_len - 1


def storage_bytes(tree: Any) -> int:
    """Bytes of the distinct storages of ``tree``'s tensors."""
    seen: Dict[int, int] = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


def trace(cfg: ModelConfig, shape: ShapeConfig, mesh=None, device: str = "cuda",
          **step_kw) -> Tuple[ModuleCosts, int]:
    """Run ``make_step(cfg, shape, mesh=mesh, **step_kw)`` once on fake
    stand-ins of this rank's arguments (:func:`_stand_ins`) on ``device``,
    under a :class:`CostCounter`: its counts, and the bytes of the
    arguments.  ``mesh`` None is the one-card step; a mesh needs a world
    (``fake_world`` for a production one)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    # the mesh's own rank tensors are real: let them in
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = _stand_ins(cfg, shape, mesh, step_kw, device)
        kw = dict(step_kw, device=device) if shape.kind == "train" else step_kw
        step = make_step(cfg, shape, mesh=mesh, **kw)
        with CostCounter() as counter:
            out = step(*args)
        del out
        return counter.costs, storage_bytes(args)


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True,
             variant: str = "", device: Optional[str] = None) -> dict:
    """Trace one cell's step as rank 0 of a fake world of the production
    mesh's size, on fake tensors on ``device`` (None: "cuda"), and return
    its record: the reference's keys (the ``Roofline`` terms, ``status``,
    ``variant``, ``step``, ``memory_analysis``) with ``trace_s`` and
    ``device``.  A cell the reference skips comes back "skipped" with its
    reason, before any world is made."""
    device = "cuda" if device is None else device
    cfg = get_config(arch)
    reason = skip_reason(cfg, shape_name)
    if reason is not None:
        return {"arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
                "status": "skipped", "reason": reason}
    shape = shapes_for(cfg)[shape_name]
    cfg, shape, (mesh_dims, axes), step_kw = _apply_variant(cfg, shape, multi_pod,
                                                            variant)
    mesh_name = "x".join(str(s) for s in mesh_dims)
    n_dev = math.prod(mesh_dims)
    t0 = time.perf_counter()
    with fake_world(n_dev):
        costs, arg_bytes = trace(cfg, shape, make_mesh_compat(mesh_dims, axes, device),
                                 device, **step_kw)
    trace_s = time.perf_counter() - t0
    r = rl.derive(arch, shape_name, mesh_name, costs, n_dev, cfg=cfg, shape=shape,
                  model_flops_global=model_flops(cfg, shape),
                  peak_memory_bytes=float(arg_bytes + costs.peak_bytes))
    rec = r.to_dict()
    rec.update(
        status="ok",
        variant=variant,
        trace_s=round(trace_s, 1),
        device=device,
        step=f"{shape.kind}:{cfg.name}:{shape.name}",
        memory_analysis={
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": costs.live_bytes,
            "temp_size_in_bytes": costs.peak_bytes - costs.live_bytes,
        },
    )
    if verbose:
        ma = rec["memory_analysis"]
        print(
            f"[{rec['step']} @ {mesh_name}] trace {trace_s:.0f}s | "
            f"args {ma['argument_size_in_bytes']/2**30:.2f} GiB  "
            f"temp {ma['temp_size_in_bytes']/2**30:.2f} GiB | "
            f"t_comp {r.t_compute*1e3:.1f}ms t_mem {r.t_memory*1e3:.1f}ms "
            f"t_coll {r.t_collective*1e3:.1f}ms -> {r.bottleneck} | "
            f"useful {100*(r.useful_flops_frac or 0):.0f}% "
            f"roofline {100*r.roofline_frac:.0f}%",
            flush=True,
        )
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="single",
                    choices=("single", "multi", "both"))
    ap.add_argument("--variant", default="", help="'+'-joined variant tokens")
    ap.add_argument("--out", default=None, help="JSON results path")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the fake tensors' device (cpu on a CPU-only build)")
    ap.add_argument("--cell", action="append", default=[],
                    help="arch:shape[:multi], repeatable: these cells instead of "
                         "the --arch/--shape/--mesh product")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else (args.arch,)
    shapes = tuple(SHAPES) if (args.all or args.shape is None) else (args.shape,)
    meshes = {"single": (False,), "multi": (True,), "both": (False, True)}[args.mesh]
    cells = [(arch, shape_name, multi) for multi in meshes for arch in archs
             for shape_name in shapes]
    if args.cell:
        cells = [(c.split(":")[0], c.split(":")[1], c.split(":")[2:] == ["multi"])
                 for c in args.cell]

    results = []
    for arch, shape_name, multi in cells:
        try:
            rec = run_cell(arch, shape_name, multi, variant=args.variant,
                           device=args.device)
        except Exception as e:
            rec = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(multi),
                   "status": "error", "error": repr(e),
                   "trace": traceback.format_exc()[-2000:]}
            print(f"[{arch}:{shape_name}] ERROR {e!r}", flush=True)
        results.append(rec)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1, default=str)
    ok = sum(1 for r in results if r["status"] == "ok")
    sk = sum(1 for r in results if r["status"] == "skipped")
    err = sum(1 for r in results if r["status"] == "error")
    print(f"\ndry-run: {ok} ok, {sk} skipped, {err} errors "
          f"/ {len(results)} cells")
    return 1 if err else 0


if __name__ == "__main__":
    raise SystemExit(main())
