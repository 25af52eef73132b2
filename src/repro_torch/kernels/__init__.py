"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and the
device dispatch.

rmsnorm          — fused row norm (``csrc/rmsnorm.cu``)
flash_attention  — online-softmax attention forward, causal/window/GQA
                   (``csrc/flash_attention.cu``)
decode_attention — single-token flash-decode over (ring) KV caches
                   (``csrc/decode_attention.cu``)
ref              — the plain versions; ops — dispatch by device
build            — nvcc at first use into ``_build/``, loaded with ctypes
"""

from . import ops, ref

__all__ = ["ops", "ref"]
