from .engine import (Request, ServeConfig, ServingEngine,  # noqa: F401
                     make_decode_step, make_prefill_step)
