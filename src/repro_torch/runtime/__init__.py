from . import elastic, queueing, serve, steps, swarm, train_loop
from .serve import AdmissionController, ServeConfig, Server, schedule_requests
from .steps import (TrainConfig, init_opt_state, make_decode_step, make_prefill_step,
                    make_train_step)

__all__ = ["AdmissionController", "ServeConfig", "Server", "TrainConfig", "elastic",
           "init_opt_state", "make_decode_step", "make_prefill_step", "make_train_step",
           "queueing", "schedule_requests", "serve", "steps", "swarm", "train_loop"]
