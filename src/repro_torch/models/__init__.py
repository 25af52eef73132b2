from . import attention, cnn, common, convert, moe, ssm, transformer
from .convert import cnn_from_jax_params, from_jax_params
from .transformer import decode_step, init_cache, init_params, prefill

__all__ = ["attention", "cnn", "cnn_from_jax_params", "common", "convert", "decode_step",
           "from_jax_params",
           "init_cache", "init_params", "moe", "prefill", "ssm", "transformer"]
