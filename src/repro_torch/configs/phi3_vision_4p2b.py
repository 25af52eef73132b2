"""phi-3-vision-4.2b — 32L d3072 32H(kv32) d_ff8192 vocab32064, phi3-mini
backbone + CLIP frontend (stubbed: input_specs provides patch embeddings)
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3_vision_4p2b", family="vlm", n_layers=32, d_model=3072,
    n_heads=32, n_kv=32, d_ff=8192, vocab=32064, embed_stub=True,
)
