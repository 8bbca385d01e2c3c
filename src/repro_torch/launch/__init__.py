"""Launchers: the step factories (``steps.py``: train, prefill, decode),
the training loop with PMEM checkpoints and crash injection
(``train.py``) and the serving launcher (``serve.py``)."""

from repro_torch.launch.steps import (
    make_decode_step,
    make_prefill_step,
    make_step,
    make_train_step,
)

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step", "make_step"]
