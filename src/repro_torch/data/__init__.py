"""Data pipeline of the port."""
from repro_torch.data.pipeline import TokenPipeline  # noqa: F401
