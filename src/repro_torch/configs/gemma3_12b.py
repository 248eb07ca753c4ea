"""Gemma3-12B: 5 local (window 1024) : 1 global pattern, 128k context
[hf:google/gemma-3-12b-pt]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv=8, head_dim=256,
    d_ff=15360, vocab=262144, local_global_period=5, local_window=1024,
    rope_theta=1e6, grad_accum=2,
)
