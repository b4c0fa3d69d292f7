from .pipeline import DataConfig, DataPipeline  # noqa: F401
