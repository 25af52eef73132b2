from . import queueing, serve, steps, swarm
from .serve import AdmissionController, ServeConfig, Server, schedule_requests
from .steps import make_decode_step, make_prefill_step

__all__ = ["AdmissionController", "ServeConfig", "Server", "make_decode_step",
           "make_prefill_step", "queueing", "schedule_requests", "serve", "steps",
           "swarm"]
