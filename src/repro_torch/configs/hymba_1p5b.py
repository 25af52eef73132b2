"""hymba-1.5b — 32L d1600 25H(kv5) d_ff5504 vocab32001, ssm_state=16,
parallel attn+mamba heads per block [arXiv:2411.13676; hf]"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba_1p5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv=5, d_ff=5504, vocab=32001,
    ssm=SSMConfig(d_state=16), block_pattern=("hybrid",),
    subquadratic=True,  # SSM path carries long contexts; attn window-able
    window=1024, attn="swa",  # hymba uses mostly-SWA attention + meta tokens
)
