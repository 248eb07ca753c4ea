"""Data pipelines of the port (counterpart of ``repro/data``)."""
from .pipeline import SyntheticLMData

__all__ = ["SyntheticLMData"]
