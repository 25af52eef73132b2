"""h2o-danube-3-4b — 24L d3840 32H(kv8) d_ff10240 vocab32000, llama+mistral
mix with sliding-window attention [arXiv:2401.16818; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o_danube3_4b", family="dense", n_layers=24, d_model=3840,
    n_heads=32, n_kv=8, d_ff=10240, vocab=32000, attn="swa", window=4096,
    subquadratic=True,  # SWA bounds KV — long_500k runnable
)
