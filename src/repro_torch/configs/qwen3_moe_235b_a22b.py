"""Qwen3-MoE-235B-A22B: 128 experts top-8, qk-norm GQA
[hf:Qwen/Qwen3-30B-A3B family scaling; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv=4, head_dim=128,
    d_ff=0, expert_d_ff=1536, vocab=151936,
    n_experts=128, top_k=8, qk_norm=True, rope_theta=1e6, grad_accum=4,
)
