"""xlstm-1.3b — 48L d2048 4H d_ff=0 vocab50304, sLSTM + mLSTM blocks (7:1)
[arXiv:2405.04517; unverified]"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm_1p3b", family="ssm", n_layers=48, d_model=2048,
    n_heads=4, n_kv=4, d_ff=0, vocab=50304,
    ssm=SSMConfig(d_state=16),
    block_pattern=("mlstm",) * 7 + ("slstm",),
    subquadratic=True,
)
