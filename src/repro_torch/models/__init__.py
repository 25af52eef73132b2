from . import attention, common, convert, ssm, transformer
from .convert import from_jax_params
from .transformer import decode_step, init_cache, init_params, prefill

__all__ = ["attention", "common", "convert", "decode_step", "from_jax_params",
           "init_cache", "init_params", "prefill", "ssm", "transformer"]
