"""Marvel on PyTorch and CUDA: the port of the ``repro`` package to an
NVIDIA H100.

It mirrors the reference package module for module.  So far it holds the
storage substrate, the stateful function runtime and gateway, the
dataflow and MapReduce engines, the cluster layer, the device execution
mode, and Marvel-Serve (the KV pager and serving pool) over the
dense-attention models.  The MapReduce partition step, prefill attention
and every decode step run the hand-written CUDA kernels in
:mod:`repro_torch.kernels`.  Entry points run on the card unless the
caller asks for the CPU.
"""
