"""Mamba2-1.3B: SSD (state-space duality), attention-free
[arXiv:2405.21060]. Vocab padded 50280 -> 50432."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv=0, head_dim=0,
    d_ff=0, vocab=50432, ssm_state=128, ssm_heads=64, ssm_head_dim=64,
    ssm_expand=2,
)
