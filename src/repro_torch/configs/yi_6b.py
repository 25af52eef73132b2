"""yi-6b — 32L d4096 32H(kv4) d_ff11008 vocab64000, llama-arch GQA
[arXiv:2403.04652; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi_6b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv=4, d_ff=11008, vocab=64000,
)
