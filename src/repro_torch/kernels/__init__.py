"""Hand-written CUDA kernels for Hopper replacing the reference package's
Pallas TPU kernels, each with a plain PyTorch version beside it:

  * bucket_histogram: MapReduce shuffle partition counting
    (``csrc/bucket_histogram.cu``);
  * flash_attention: prefill and training attention forward
    (``csrc/flash_attention.cu``), and its backward
    (``csrc/flash_attention_bwd.cu``, under autograd through
    ``flash_attention_bwd.FlashAttention``);
  * decode_attention: single-token attention over a KV cache, every
    decode step (``csrc/decode_attention.cu``);
  * ssd_scan: the Mamba-2 SSD within-chunk step, every Mamba-2 prefill
    (``csrc/ssd_scan.cu``).

Sources are compiled with ``nvcc`` at first use (``_build.py``).
"""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
