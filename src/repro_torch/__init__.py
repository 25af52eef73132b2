"""PyTorch / CUDA port of ``repro`` for one NVIDIA H100.

The LM serving path (``runtime.serve.Server``) for every block kind of the
reference, its training path (``runtime.steps.make_train_step``,
``runtime.train_loop``), and the paper's placement path, with hand-written
CUDA kernels (``kernels/csrc``).  Imports ``torch``, numpy and scipy only; no
kernel is built or loaded until a CUDA tensor first reaches it.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
