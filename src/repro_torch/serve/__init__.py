from .engine import Request, ServeConfig, ServingEngine  # noqa: F401
