"""Process-group runs for ``tests/test_torch_dryrun.py``, as a script.

    python tests/dryrun_worlds.py port OUT       # the port's worlds
    python tests/dryrun_worlds.py reference OUT  # the reference's variant parse

Port side, each in a world of its own (no process group is ever made in
the test process):

* ``real_world4.json``: the reduced qwen2.5-3b train step on a gloo
  world of 4 ranks, (2, 2) over (data, model), one step, rank 0 counted by
  ``CostCounter`` (spawned; rendezvous file in OUT), and rank 0's attempt
  to join a fake world from inside it;
* ``fake_world4.json``: the same step traced as rank 0 of a fake world of
  4 on fake CPU tensors (``dryrun.trace``);
* ``cells.json``: ``dryrun.run_cell`` on the reference test's cells
  (``tests/test_dryrun.py``) at full width on fake CPU tensors, and the
  CLI's exit code and records for the multi-pod cell.

Both steps compute in f32, as ``tests/sharded_train_worlds.py`` patches
them (gloo's collectives in f32).  The reference side imports
``repro.launch.dryrun``, which sets ``XLA_FLAGS`` to 512 host devices at
import: only ever in this subprocess.
"""

from __future__ import annotations

import json
import os
import sys

import sharded_train_worlds as sw

MESH = (2, 2)
#: the reference test's cells: (arch, shape, multi_pod)
CELLS = (("gemma-2b", "decode_32k", False), ("mamba2-2.7b", "long_500k", False),
         ("gemma-2b", "decode_32k", True), ("hubert-xlarge", "decode_32k", False),
         ("qwen2.5-3b", "long_500k", False))
#: (arch, shape, variant) parsed by both packages
VARIANTS = (
    ("qwen2.5-3b", "train_4k", ""),
    ("qwen2.5-3b", "train_4k", "zero1+tp2+mb2"),
    ("qwen1.5-32b", "prefill_32k", "pad-heads+tp8"),
    ("gemma-2b", "decode_32k", "no-fsdp+int8-cache"),
    ("deepseek-v2-lite-16b", "train_4k", "zero1+tp8"),
    ("mamba2-2.7b", "train_4k", "remat-save+mb16"),
    ("gemma2-9b", "train_4k", "tp1+remat-save"),
    ("qwen2.5-3b", "prefill_32k", "tp4+no-fsdp"),
)


def _shape():
    from repro_torch.models import ShapeConfig

    return ShapeConfig(**sw.shape_kw({}))


def _world4(rank: int, out: str) -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, make_batch
    from repro_torch.launch import (
        CostCounter, fake_world, make_mesh_compat, make_train_step, process_group)
    from repro_torch.models import init_params, model_defs, reduced_for_smoke
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import param_pspecs, shard_tree

    sw._f32_compute()
    with process_group(rank, 4, os.path.join(out, "rdzv4"), "cpu"):
        cfg = reduced_for_smoke(get_config("qwen2.5-3b"))
        mesh = make_mesh_compat(MESH, sw.DM, "cpu")
        params = init_params(model_defs(cfg), torch.Generator().manual_seed(0), "cpu",
                             dtype=torch.float32)
        params = shard_tree(params, param_pspecs(cfg, mesh), mesh)
        opt = adamw_init(params)
        batch = make_batch(PipelineConfig(vocab=cfg.vocab, seq_len=sw.SEQ,
                                          global_batch=sw.BATCH), 0)
        step = make_train_step(cfg, _shape(), device="cpu", mesh=mesh)
        if rank:
            step(params, opt, batch)
            return
        with CostCounter() as counter:
            step(params, opt, batch)
        try:
            with fake_world(4):
                refused = None
        except RuntimeError as e:
            refused = str(e)
        c = counter.costs
        with open(os.path.join(out, "real_world4.json"), "w") as f:
            json.dump({"collective_bytes": c.collective_bytes,
                       "link_bytes": c.link_bytes, "dot_flops": c.dot_flops,
                       "kernel_calls": c.kernel_calls, "refused": refused}, f)


def _fake_world4(out: str) -> None:
    from repro_torch.configs import get_config
    from repro_torch.launch import fake_world, make_mesh_compat
    from repro_torch.launch.dryrun import trace
    from repro_torch.models import reduced_for_smoke

    cfg = reduced_for_smoke(get_config("qwen2.5-3b"))
    with fake_world(4):
        c, _ = trace(cfg, _shape(), make_mesh_compat(MESH, sw.DM, "cpu"), "cpu")
    with open(os.path.join(out, "fake_world4.json"), "w") as f:
        json.dump({"collective_bytes": c.collective_bytes, "link_bytes": c.link_bytes,
                   "dot_flops": c.dot_flops, "kernel_calls": c.kernel_calls}, f)


def _cells(out: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch import dryrun

    recs = [dryrun.run_cell(arch, shape, multi, verbose=False, device="cpu")
            for arch, shape, multi in CELLS]
    cli_out = os.path.join(out, "cli.json")
    rc = dryrun.main(["--cell", "gemma-2b:decode_32k:multi", "--device", "cpu",
                      "--out", cli_out])
    with open(cli_out) as f:
        cli = json.load(f)
    with open(os.path.join(out, "cells.json"), "w") as f:
        json.dump({"cells": recs, "cli_rc": rc, "cli": cli,
                   "left_initialised": dist.is_initialized()}, f, default=str)


def run_port(out: str) -> None:
    import torch.multiprocessing as mp

    world4 = mp.start_processes(_world4, args=(out,), nprocs=4, join=False,
                                start_method="spawn")
    sw._f32_compute()
    _fake_world4(out)
    _cells(out)
    while not world4.join():
        pass


def run_reference(out: str) -> None:
    from repro.launch.dryrun import _apply_variant  # first: it sets XLA_FLAGS
    from repro.configs import get_config
    from repro.configs.shapes import shapes_for

    parsed = []
    for arch, shape_name, variant in VARIANTS:
        cfg, shape, mesh, kw = _apply_variant(
            get_config(arch), shapes_for(get_config(arch))[shape_name], False, variant)
        parsed.append({"pad_heads": cfg.pad_heads, "mesh": list(mesh.devices.shape),
                       "axes": list(mesh.axis_names), "step_kw": kw,
                       "remat": shape.remat, "microbatches": shape.microbatches})
    try:
        _apply_variant(get_config("qwen2.5-3b"),
                       shapes_for(get_config("qwen2.5-3b"))["train_4k"], False, "tp3")
        unknown = None
    except ValueError as e:
        unknown = str(e)
    with open(os.path.join(out, "ref_variants.json"), "w") as f:
        json.dump({"parsed": parsed, "unknown": unknown}, f)


if __name__ == "__main__":
    side, folder = sys.argv[1], sys.argv[2]
    {"reference": run_reference, "port": run_port}[side](folder)
