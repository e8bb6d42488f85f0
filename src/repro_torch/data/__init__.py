from .pipeline import (DataConfig, FileSource, Prefetcher, SyntheticSource,
                       TokenPipeline, to_device)

__all__ = ["DataConfig", "TokenPipeline", "SyntheticSource", "FileSource",
           "Prefetcher", "to_device"]
