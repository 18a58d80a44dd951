"""The training-data pipeline over the blob store (a verbatim copy of
:mod:`repro.data.pipeline`)."""

from repro_torch.data.pipeline import PipelineConfig, TokenPipeline, write_token_corpus

__all__ = ["PipelineConfig", "TokenPipeline", "write_token_corpus"]
