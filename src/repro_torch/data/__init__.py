"""The blob store's data sources, verbatim copies of :mod:`repro.data`: the
training-data pipeline and the paper's synthetic telescope sky; and
:mod:`repro_torch.data.detect`, the sky's difference imaging on the device."""

from repro_torch.data.pipeline import PipelineConfig, TokenPipeline, write_token_corpus
from repro_torch.data.sky import SkyLayout, SkySimulator, detect_transients

__all__ = ["PipelineConfig", "TokenPipeline", "write_token_corpus",
           "SkyLayout", "SkySimulator", "detect_transients"]
