"""LeNet and VGG-16 in PyTorch — the paper's own inference workloads (port
of ``repro/models/cnn.py``).

Each model exposes per-unit apply functions so the execution engine can run
a *placed* inference: unit j runs "on" node ``assign[j]`` (simulated), with
the intermediate activation shipped between placement units exactly as the
OULD objective prices it.  ``apply_layers(fns, x, start, end)`` runs a
contiguous unit range.

The units take and return the reference's NHWC layout.  A convolution
hands cuDNN a ``permute`` view (NCHW with channels-last strides, no copy)
and returns the NHWC view of its output.  Conv weights are stored as OIHW in
channels-last memory (what ``F.conv2d`` takes); they are drawn, like the
reference's, in its HWIO shape with scale ``fan_in ** -0.5``
(``models/convert.py::cnn_from_jax_params`` converts the reference's own).
LeNet's convolutions are VALID and VGG's SAME (pad 1); pooling is 2×2,
stride 2, floor.  Dense weights keep the reference's (in, out) layout.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn.functional as F

from ..device import resolve_device


def _normal(gen: torch.Generator, fan_in: int, shape: tuple[int, ...],
            dev: torch.device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device) * fan_in ** -0.5).to(dev)


def conv_weight(w_hwio: torch.Tensor) -> torch.Tensor:
    """A reference HWIO kernel as the OIHW, channels-last tensor the port's
    convolution takes."""
    return w_hwio.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, padding: int) -> torch.Tensor:
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=padding)
    return y.permute(0, 2, 3, 1)


def _pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _dense(x: torch.Tensor, p: dict) -> torch.Tensor:
    return x @ p["w"] + p["b"]


# ---------------------------------------------------------------------------
# LeNet — 7 placement units (matches core.profiles.lenet_profile)
# ---------------------------------------------------------------------------

def lenet_init(gen: torch.Generator, height: int = 326, width: int = 595,
               channels: int = 3, num_classes: int = 10,
               device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    h, w = (height - 4) // 2, (width - 4) // 2
    h, w = (h - 4) // 2, (w - 4) // 2
    flat = h * w * 16

    def zeros(n):
        return torch.zeros(n, device=dev)

    return {
        "conv1": {"w": conv_weight(_normal(gen, 75, (5, 5, channels, 6), dev)), "b": zeros(6)},
        "conv2": {"w": conv_weight(_normal(gen, 150, (5, 5, 6, 16), dev)), "b": zeros(16)},
        "fc1": {"w": _normal(gen, flat, (flat, 120), dev), "b": zeros(120)},
        "fc2": {"w": _normal(gen, 120, (120, 84), dev), "b": zeros(84)},
        "fc3": {"w": _normal(gen, 84, (84, num_classes), dev), "b": zeros(num_classes)},
    }


def lenet_layers(params: dict) -> list[Callable]:
    return [
        lambda x: torch.relu(_conv(x, params["conv1"]["w"], params["conv1"]["b"], 0)),
        lambda x: _pool(x),
        lambda x: torch.relu(_conv(x, params["conv2"]["w"], params["conv2"]["b"], 0)),
        lambda x: _pool(x).reshape(x.shape[0], -1),   # flattens in NHWC order
        lambda x: torch.relu(_dense(x, params["fc1"])),
        lambda x: torch.relu(_dense(x, params["fc2"])),
        lambda x: _dense(x, params["fc3"]),
    ]


# ---------------------------------------------------------------------------
# VGG-16 — 18 placement units (13 conv + 5 pool, head folded into unit 18)
# ---------------------------------------------------------------------------

_VGG_CFG = (64, 64, "p", 128, 128, "p", 256, 256, 256, "p",
            512, 512, 512, "p", 512, 512, 512, "p")


def vgg16_init(gen: torch.Generator, channels: int = 3, num_classes: int = 10,
               device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    params: dict = {}
    cin = channels
    for li, cfg in enumerate(_VGG_CFG):
        if cfg == "p":
            continue
        params[f"conv{li}"] = {"w": conv_weight(_normal(gen, 9 * cin, (3, 3, cin, cfg), dev)),
                               "b": torch.zeros(cfg, device=dev)}
        cin = cfg
    head_in = 7 * 7 * 512
    for name, (fan_in, fan_out) in (("fc6", (head_in, 4096)), ("fc7", (4096, 4096)),
                                    ("fc8", (4096, num_classes))):
        params[name] = {"w": _normal(gen, fan_in, (fan_in, fan_out), dev),
                        "b": torch.zeros(fan_out, device=dev)}
    return params


def _vgg_head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The reference's pool to a 7×7 grid, then the three FC layers (the
    folded unit): zero-pad h or w up to 7, crop each to a multiple of 7 and
    take the mean of each block (not ``adaptive_avg_pool2d``, whose windows
    overlap where 7 does not divide the size)."""
    b, h, w, c = x.shape
    if h < 7 or w < 7:  # tiny test frames: zero-pad up to the pool grid
        x = F.pad(x, (0, 0, 0, max(0, 7 - w), 0, max(0, 7 - h)))
        h, w = max(h, 7), max(w, 7)
    hs, ws = h // 7, w // 7
    x = x[:, : hs * 7, : ws * 7]
    x = x.reshape(b, 7, hs, 7, ws, c).mean(dim=(2, 4))
    x = x.reshape(b, -1)
    x = torch.relu(_dense(x, params["fc6"]))
    x = torch.relu(_dense(x, params["fc7"]))
    return _dense(x, params["fc8"])


def vgg16_layers(params: dict) -> list[Callable]:
    fns: list[Callable] = []
    for li, cfg in enumerate(_VGG_CFG):
        if cfg == "p":
            if li == len(_VGG_CFG) - 1:
                fns.append(lambda x: _vgg_head(params, _pool(x)))
            else:
                fns.append(_pool)
        else:
            p = params[f"conv{li}"]
            fns.append(functools.partial(
                lambda x, p: torch.relu(_conv(x, p["w"], p["b"], 1)), p=p))
    return fns


def apply_layers(layer_fns: list[Callable], x: torch.Tensor,
                 start: int = 0, end: int | None = None) -> torch.Tensor:
    """Run units [start, end) — the placed-inference execution primitive."""
    end = end if end is not None else len(layer_fns)
    for fn in layer_fns[start:end]:
        x = fn(x)
    return x
