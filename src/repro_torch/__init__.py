"""Marvel on PyTorch and CUDA: the port of the ``repro`` package to an
NVIDIA H100.

It mirrors the reference package module for module.  So far it holds the
storage substrate, the stateful function runtime and gateway, the
dataflow and MapReduce engines, the cluster layer and the device
execution mode, whose partition step runs the hand-written CUDA kernel in
:mod:`repro_torch.kernels`.  Entry points run on the card unless the
caller asks for the CPU.
"""
