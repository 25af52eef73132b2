"""Per-layer cost profiles — the paper's (m_j, c_j, K_j) triples.

The paper characterizes each CNN layer j by a memory requirement ``m_j``,
a computation demand ``c_j`` and the size ``K_j`` of the activation it ships
to the next layer (§III-A).  We generalize that to any layered model:
LeNet / VGG-16 (the paper's own workloads) and the transformer-family
architectures this framework supports.  Profiles are analytic — derived from
the layer hyper-parameters, never from tracing — so they are cheap enough to
recompute inside the placement loop (OULD re-solve on topology change).

Units: memory in bytes, compute in FLOPs, activation sizes in bytes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class LayerProfile:
    """The paper's (m_j, c_j, K_j) for one placement unit."""

    name: str
    memory_bytes: float        # m_j: params + working activations resident on the node
    compute_flops: float       # c_j: FLOPs to execute the layer once
    output_bytes: float        # K_j: activation shipped to layer j+1
    params_bytes: float = 0.0  # informational split of memory_bytes


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Ordered layer profiles for one model + the input size K_s."""

    name: str
    layers: tuple[LayerProfile, ...]
    input_bytes: float  # K_s: the source image / token batch shipped to layer 1

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @property
    def total_memory(self) -> float:
        return sum(ly.memory_bytes for ly in self.layers)

    @property
    def total_flops(self) -> float:
        return sum(ly.compute_flops for ly in self.layers)

    def memory_vector(self) -> list[float]:
        return [ly.memory_bytes for ly in self.layers]

    def compute_vector(self) -> list[float]:
        return [ly.compute_flops for ly in self.layers]

    def output_vector(self) -> list[float]:
        """K_j for j = 1..M (K_M is the classification result, tiny)."""
        return [ly.output_bytes for ly in self.layers]


# ---------------------------------------------------------------------------
# CNN profiles (paper workloads): LeNet (7 sub-tasks) and VGG-16 (18 sub-tasks)
# ---------------------------------------------------------------------------

def _conv2d_profile(name: str, h: int, w: int, cin: int, cout: int, k: int,
                    stride: int = 1, pad: str = "same",
                    dtype_bytes: int = 4) -> tuple[LayerProfile, int, int]:
    if pad == "same":
        ho, wo = math.ceil(h / stride), math.ceil(w / stride)
    else:  # valid
        ho, wo = (h - k) // stride + 1, (w - k) // stride + 1
    params = (k * k * cin + 1) * cout
    flops = 2.0 * k * k * cin * cout * ho * wo
    out_bytes = ho * wo * cout * dtype_bytes
    mem = params * dtype_bytes + out_bytes + h * w * cin * dtype_bytes
    return (LayerProfile(name, mem, flops, out_bytes, params * dtype_bytes), ho, wo)


def _pool_profile(name: str, h: int, w: int, c: int, k: int,
                  dtype_bytes: int = 4) -> tuple[LayerProfile, int, int]:
    ho, wo = h // k, w // k
    flops = 1.0 * k * k * c * ho * wo
    out_bytes = ho * wo * c * dtype_bytes
    mem = out_bytes + h * w * c * dtype_bytes
    return (LayerProfile(name, mem, flops, out_bytes, 0.0), ho, wo)


def _dense_profile(name: str, fan_in: int, fan_out: int,
                   dtype_bytes: int = 4) -> LayerProfile:
    params = (fan_in + 1) * fan_out
    flops = 2.0 * fan_in * fan_out
    out_bytes = fan_out * dtype_bytes
    mem = params * dtype_bytes + out_bytes + fan_in * dtype_bytes
    return LayerProfile(name, mem, flops, out_bytes, params * dtype_bytes)


def lenet_profile(height: int = 326, width: int = 595, channels: int = 3,
                  dtype_bytes: int = 4) -> ModelProfile:
    """LeNet-5 style, 7 placement units (paper: 'Lenet composed of 7 layers').

    The paper classifies 595x326 RGB frames from the Stanford Drone Dataset;
    we keep the classic LeNet filter counts but honor the paper's input size.
    """
    layers: list[LayerProfile] = []
    h, w = height, width
    p, h, w = _conv2d_profile("conv1", h, w, channels, 6, 5, pad="valid",
                              dtype_bytes=dtype_bytes)
    layers.append(p)
    p, h, w = _pool_profile("pool1", h, w, 6, 2, dtype_bytes)
    layers.append(p)
    p, h, w = _conv2d_profile("conv2", h, w, 6, 16, 5, pad="valid",
                              dtype_bytes=dtype_bytes)
    layers.append(p)
    p, h, w = _pool_profile("pool2", h, w, 16, 2, dtype_bytes)
    layers.append(p)
    flat = h * w * 16
    layers.append(_dense_profile("fc1", flat, 120, dtype_bytes))
    layers.append(_dense_profile("fc2", 120, 84, dtype_bytes))
    layers.append(_dense_profile("fc3", 84, 10, dtype_bytes))
    input_bytes = height * width * channels * 1.0  # uint8 capture, K_s
    return ModelProfile("lenet", tuple(layers), input_bytes)


_VGG16_CFG: Sequence[tuple[str, int]] = (
    ("conv", 64), ("conv", 64), ("pool", 0),
    ("conv", 128), ("conv", 128), ("pool", 0),
    ("conv", 256), ("conv", 256), ("conv", 256), ("pool", 0),
    ("conv", 512), ("conv", 512), ("conv", 512), ("pool", 0),
    ("conv", 512), ("conv", 512), ("conv", 512), ("pool", 0),
)


def vgg16_profile(height: int = 326, width: int = 595, channels: int = 3,
                  dtype_bytes: int = 4, num_classes: int = 10,
                  merge_to: int = 18) -> ModelProfile:
    """VGG-16 as 18 placement units (paper: 'VGG-16 that comprises 18 layers').

    13 conv + 5 pool = 18 feature units; the 3 FC layers are folded into the
    last pool unit so the unit count matches the paper's M=18.  (The paper
    counts 'sub-tasks', not keras layers; 18 is their number.)
    """
    layers: list[LayerProfile] = []
    h, w, c = height, width, channels
    for kind, cout in _VGG16_CFG:
        if kind == "conv":
            p, h, w = _conv2d_profile(f"conv{len(layers)}", h, w, c, cout, 3,
                                      dtype_bytes=dtype_bytes)
            c = cout
        else:
            p, h, w = _pool_profile(f"pool{len(layers)}", h, w, c, 2, dtype_bytes)
        layers.append(p)
    # Fold classifier head into the final unit (adaptive-pool 7x7 + 3 FC).
    head_in = 7 * 7 * 512
    head = [
        _dense_profile("fc6", head_in, 4096, dtype_bytes),
        _dense_profile("fc7", 4096, 4096, dtype_bytes),
        _dense_profile("fc8", 4096, num_classes, dtype_bytes),
    ]
    last = layers[-1]
    layers[-1] = LayerProfile(
        name=last.name + "+head",
        memory_bytes=last.memory_bytes + sum(x.memory_bytes for x in head),
        compute_flops=last.compute_flops + sum(x.compute_flops for x in head),
        output_bytes=head[-1].output_bytes,
        params_bytes=last.params_bytes + sum(x.params_bytes for x in head),
    )
    assert len(layers) == merge_to, len(layers)
    input_bytes = height * width * channels * 1.0
    return ModelProfile("vgg16", tuple(layers), input_bytes)


# ---------------------------------------------------------------------------
# Transformer profiles — placement units are decoder blocks (+ embed / head)
# ---------------------------------------------------------------------------

def transformer_block_flops(d_model: int, n_heads: int, n_kv: int, d_ff: int,
                            seq: int, *, head_dim: int | None = None,
                            moe_experts: int = 0, moe_topk: int = 0,
                            window: int | None = None,
                            causal: bool = True) -> float:
    """Analytic per-token-batch FLOPs of one decoder block over ``seq`` tokens."""
    hd = head_dim if head_dim is not None else d_model // max(n_heads, 1)
    qkv = 2.0 * seq * d_model * (n_heads + 2 * n_kv) * hd
    proj = 2.0 * seq * n_heads * hd * d_model
    ctx = min(seq, window) if window else seq
    attn_scores = 2.0 * seq * ctx * n_heads * hd * (0.5 if causal and not window else 1.0)
    attn = 2 * attn_scores  # scores + weighted sum
    if moe_experts and moe_topk:
        ffn = 2.0 * seq * d_model * d_ff * 3 * moe_topk  # gate/up/down per routed expert
        router = 2.0 * seq * d_model * moe_experts
        ffn += router
    elif d_ff > 0:
        ffn = 2.0 * seq * d_model * d_ff * 3
    else:
        ffn = 0.0
    return qkv + proj + attn + ffn


def transformer_block_params(d_model: int, n_heads: int, n_kv: int, d_ff: int,
                             *, head_dim: int | None = None,
                             moe_experts: int = 0) -> float:
    hd = head_dim if head_dim is not None else d_model // max(n_heads, 1)
    attn = d_model * (n_heads + 2 * n_kv) * hd + n_heads * hd * d_model
    if moe_experts:
        ffn = moe_experts * 3.0 * d_model * d_ff + d_model * moe_experts
    elif d_ff > 0:
        ffn = 3.0 * d_model * d_ff
    else:
        ffn = 0.0
    norms = 2.0 * d_model
    return attn + ffn + norms


def lm_profile(name: str, *, n_layers: int, d_model: int, n_heads: int,
               n_kv: int, d_ff: int, vocab: int, seq: int, batch: int = 1,
               head_dim: int | None = None, moe_experts: int = 0,
               moe_topk: int = 0, window: int | None = None,
               dtype_bytes: int = 2) -> ModelProfile:
    """Per-block (m_j, c_j, K_j) for a decoder LM — placement units are blocks,
    with embedding and LM head as the first/last units (the paper's layer-wise
    granularity, adapted per DESIGN.md §2)."""
    act = batch * seq * d_model * dtype_bytes * 1.0
    layers: list[LayerProfile] = [
        LayerProfile("embed", vocab * d_model * dtype_bytes + act,
                     2.0 * batch * seq * d_model, act,
                     vocab * d_model * dtype_bytes),
    ]
    blk_p = transformer_block_params(d_model, n_heads, n_kv, d_ff,
                                     head_dim=head_dim, moe_experts=moe_experts)
    blk_f = batch * transformer_block_flops(d_model, n_heads, n_kv, d_ff, seq,
                                            head_dim=head_dim,
                                            moe_experts=moe_experts,
                                            moe_topk=moe_topk, window=window)
    hd = head_dim if head_dim is not None else d_model // max(n_heads, 1)
    kv_bytes = batch * min(seq, window or seq) * 2 * n_kv * hd * dtype_bytes
    for j in range(n_layers):
        layers.append(LayerProfile(
            f"block{j}", blk_p * dtype_bytes + act + kv_bytes, blk_f, act,
            blk_p * dtype_bytes))
    head_flops = 2.0 * batch * seq * d_model * vocab
    layers.append(LayerProfile(
        "lm_head", vocab * d_model * dtype_bytes + batch * seq * vocab * dtype_bytes,
        head_flops, batch * seq * 4.0,  # K_M: the decision (token ids), tiny
        vocab * d_model * dtype_bytes))
    return ModelProfile(name, tuple(layers), input_bytes=batch * seq * 4.0)
