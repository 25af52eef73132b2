from . import attention, cnn, common, convert, moe, ssm, transformer, xlstm
from .convert import cnn_from_jax_params, from_jax_params
from .transformer import (decode_step, forward, init_cache, init_params, loss_fn, param_shapes,
                          prefill)

__all__ = ["attention", "cnn", "cnn_from_jax_params", "common", "convert", "decode_step",
           "forward", "from_jax_params", "init_cache", "init_params", "loss_fn", "moe",
           "param_shapes", "prefill", "ssm", "transformer", "xlstm"]
