"""musicgen-medium — 48L d1536 24H(kv24) d_ff6144 vocab2048, decoder-only over
EnCodec tokens (frontend stubbed: input_specs provides frame embeddings)
[arXiv:2306.05284; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen_medium", family="audio", n_layers=48, d_model=1536,
    n_heads=24, n_kv=24, d_ff=6144, vocab=2048, embed_stub=True,
)
