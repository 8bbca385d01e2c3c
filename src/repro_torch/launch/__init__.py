"""Launchers of the training path: the train step (``steps.py``) and the
training loop with PMEM checkpoints and crash injection (``train.py``)."""

from repro_torch.launch.steps import make_train_step

__all__ = ["make_train_step"]
