"""Device selection for the port's entry points.

The port runs on the card by default.  A caller that wants the CPU (the
parity tests) asks for it by name; asking for ``cuda`` where there is no card
raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device to run on; raises when a CUDA device is asked for and none
    is present.

    Every entry point resolves its device here, so this is also where the
    port's path turns TF32 off: f32 parity with the reference must not
    depend on it (a TF32 matmul or convolution keeps about three digits)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
