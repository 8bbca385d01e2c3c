"""Launchers: the step factories (``steps.py``: train, prefill, decode),
the training loop with PMEM checkpoints and crash injection
(``train.py``), the serving launcher (``serve.py``) and the meshes over
``torch.distributed`` (``mesh.py``)."""

from repro_torch.launch.mesh import (
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

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step", "make_step",
           "make_ctx", "make_mesh_compat", "make_production_mesh", "make_smoke_mesh",
           "process_group", "production_mesh_shape"]
