from . import ops, ref  # noqa: F401
