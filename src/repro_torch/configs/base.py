"""Model / run configuration schema (the port's own copy of
``repro.configs.base``; kept identical apart from ``production_cfg``).

One ``ModelConfig`` per architecture (full production size) plus a
``reduced()`` shrink used by CPU smoke tests.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

AttnKind = Literal["gqa", "mla", "swa", "none"]
BlockKind = Literal["attn", "mamba", "hybrid", "mlstm", "slstm"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # 'scatter'   = sort/scatter grouped-matmul under GSPMD (baseline),
    # 'shard_map' = explicit-collective expert parallelism (§Perf winner;
    #               falls back to 'scatter' off-mesh or when E % TP != 0),
    # 'einsum'    = dense one-hot dispatch (tiny smoke configs / ablation)
    impl: Literal["scatter", "einsum", "shard_map"] = "scatter"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    expand: int = 2
    chunk: int = 256          # chunked-scan block length
    conv_kernel: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # moe | dense | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int | None = None      # default d_model // n_heads
    attn: AttnKind = "gqa"
    window: int | None = None        # SWA window
    rope_theta: float = 10_000.0
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    block_pattern: tuple[BlockKind, ...] = ("attn",)  # repeated over layers
    norm_eps: float = 1e-5
    # Embedding/head tables padded so the vocab dim shards on any production
    # mesh axis (16/32-way); pad logits are masked to -inf (exactness kept).
    vocab_pad_to: int = 512
    tie_embeddings: bool = False
    embed_stub: bool = False         # audio/vlm: train inputs are embeddings
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # long_500k applicability (sub-quadratic attention available?)
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab + p - 1) // p * p

    def pattern_for_layers(self) -> tuple[BlockKind, ...]:
        p = self.block_pattern
        reps = (self.n_layers + len(p) - 1) // len(p)
        return (p * reps)[: self.n_layers]

    def reduced(self, *, n_layers: int = 2, d_model: int = 64,
                n_heads: int = 4, n_kv: int | None = None, d_ff: int | None = None,
                vocab: int = 256, experts: int = 4) -> "ModelConfig":
        """Smoke-test shrink of the same family (same block kinds/pattern)."""
        kw: dict = {}
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(self.moe, num_experts=experts,
                                            top_k=min(self.moe.top_k, 2),
                                            impl="einsum")
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                  qk_nope_head_dim=8, qk_rope_head_dim=8,
                                  v_head_dim=8)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=8, chunk=16)
        dff = d_ff if d_ff is not None else (0 if self.d_ff == 0 else 128)
        pattern = self.block_pattern
        if len(pattern) > n_layers or n_layers % len(pattern):
            uniq = tuple(dict.fromkeys(pattern))  # keep kind diversity
            assert n_layers % len(uniq) == 0, (self.name, n_layers, uniq)
            kw["block_pattern"] = uniq
        return dataclasses.replace(
            self, n_layers=n_layers, d_model=d_model, n_heads=n_heads,
            n_kv=n_kv if n_kv is not None else min(self.n_kv, n_heads),
            d_ff=dff, vocab=vocab, head_dim=d_model // n_heads,
            window=min(self.window, 32) if self.window else None,
            param_dtype="float32", compute_dtype="float32", **kw)


def production_cfg(cfg: ModelConfig) -> ModelConfig:
    """The bf16-weights / bf16-compute form the reference runs at full width
    (``repro.launch.dryrun.production_cfg``)."""
    return dataclasses.replace(cfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
