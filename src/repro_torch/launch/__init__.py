"""Launchers: the step factories (``steps.py``: train, prefill, decode),
the training loop with PMEM checkpoints and crash injection
(``train.py``), the serving launcher (``serve.py``) and the meshes over
``torch.distributed`` (``mesh.py``, with ``fake_world``).  The H100
tooling in place of the reference's TPU one: the dry run
(``dryrun.py``: each cell's step traced as one rank of a fake production
world) and its hillclimb driver (``hillclimb.py``), the cost counter
(``cost_analysis.py``, the counterpart of ``hlo_analysis.py``) and the
roofline with the card's data-sheet constants and the hand kernels' work
(``roofline.py``)."""

from repro_torch.launch.mesh import (
    fake_world,
    make_mesh_compat,
    make_production_mesh,
    make_smoke_mesh,
    process_group,
    production_mesh_shape,
)
from repro_torch.launch.steps import (
    make_ctx,
    make_decode_step,
    make_prefill_step,
    make_step,
    make_train_step,
)
from repro_torch.launch.roofline import Roofline, derive, kernel_work
from repro_torch.launch.cost_analysis import CostCounter
from repro_torch.launch.dryrun import run_cell

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step", "make_step",
           "make_ctx", "make_mesh_compat", "make_production_mesh", "make_smoke_mesh",
           "process_group", "production_mesh_shape", "fake_world", "Roofline",
           "derive", "kernel_work", "CostCounter", "run_cell"]
