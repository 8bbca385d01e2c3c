"""Input pipeline of the training path: deterministic synthetic token
batches (``pipeline.py``)."""

from repro_torch.data.pipeline import PipelineConfig, SyntheticTokens, make_batch

__all__ = ["PipelineConfig", "SyntheticTokens", "make_batch"]
