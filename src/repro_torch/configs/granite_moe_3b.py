"""granite-moe-3b-a800m — 32L d1536 24H(kv8) d_ff512 vocab49155, MoE 40e top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite_moe_3b", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv=8, d_ff=512, vocab=49155,
    moe=MoEConfig(num_experts=40, top_k=8, impl="shard_map"),
)
