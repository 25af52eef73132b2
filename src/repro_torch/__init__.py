"""PyTorch / CUDA port of ``repro`` for one NVIDIA H100.

Slice 1: the LM serving path (``runtime.serve.Server``) for dense GQA
models, with hand-written CUDA kernels for RMSNorm, flash attention and
decode attention (``kernels/csrc``).  Imports ``torch`` and numpy only; no
kernel is built or loaded until a CUDA tensor first reaches it.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
