from .base import ModelConfig, get_model  # noqa: F401
