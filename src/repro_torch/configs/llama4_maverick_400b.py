"""llama4-maverick-400b-a17b — 48L d5120 40H(kv8) d_ff8192 vocab202048,
MoE 128e top-1, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4_maverick_400b", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv=8, d_ff=8192, vocab=202048,
    moe=MoEConfig(num_experts=128, top_k=1, impl="shard_map"),
)
