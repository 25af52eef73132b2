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


def expandable_segments(on: bool = True) -> None:
    """Turn the CUDA caching allocator's expandable segments on (or off).

    With them the allocator maps pages to its blocks, splits every block
    and can unmap a free block's pages to map them where a request needs
    them, so a step runs while its allocated bytes fit the card: what
    ``launch/dryrun.py`` predicts.  On fixed segments a large segment's
    unsplit rest and the holes between blocks bind first near a full card.
    The serve and train launchers turn them on.  Segments already cached
    keep their kind: empty the cache first to switch them all."""
    setter = (getattr(torch._C, "_accelerator_setAllocatorSettings", None)
              or torch.cuda.memory._set_allocator_settings)  # the older name
    setter(f"expandable_segments:{on}")
