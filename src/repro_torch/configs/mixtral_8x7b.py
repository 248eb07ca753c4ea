"""Mixtral-8x7B: 8 experts top-2, sliding-window attention (4096)
[arXiv:2401.04088; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
    d_ff=0, expert_d_ff=14336, vocab=32000,
    n_experts=8, top_k=2, window=4096, rope_theta=1e6, grad_accum=2,
)
