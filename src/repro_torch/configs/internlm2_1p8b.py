"""internlm2-1.8b — 24L d2048 16H(kv8) d_ff8192 vocab92544, GQA
[arXiv:2403.17297; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2_1p8b", family="dense", n_layers=24, d_model=2048,
    n_heads=16, n_kv=8, d_ff=8192, vocab=92544,
)
