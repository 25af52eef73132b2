"""minicpm3-4b — 62L d2560 40H(kv40) d_ff6400 vocab73448, MLA
[hf:openbmb/MiniCPM3-4B; hf]"""
from .base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3_4b", family="dense", n_layers=62, d_model=2560,
    n_heads=40, n_kv=40, d_ff=6400, vocab=73448, attn="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64),
)
