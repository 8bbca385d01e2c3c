"""Hand-written CUDA kernels for Hopper replacing the reference package's
Pallas TPU kernels, each with a plain PyTorch version beside it:

  * bucket_histogram: MapReduce shuffle partition counting
    (``csrc/bucket_histogram.cu``)

Sources are compiled with ``nvcc`` at first use (``_build.py``).
"""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
