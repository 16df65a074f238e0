"""Synthetic data pipeline of the port (numpy) and the loss statistics
kept on the host's GK sketch."""
from .pipeline import DataConfig, StreamStats, SyntheticPipeline

__all__ = ["DataConfig", "SyntheticPipeline", "StreamStats"]
