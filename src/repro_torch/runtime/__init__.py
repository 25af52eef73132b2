from . import serve, steps
from .serve import ServeConfig, Server
from .steps import make_decode_step, make_prefill_step

__all__ = ["ServeConfig", "Server", "make_decode_step", "make_prefill_step", "serve",
           "steps"]
