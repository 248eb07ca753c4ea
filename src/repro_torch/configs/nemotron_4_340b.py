"""Nemotron-4-340B: GQA, squared-ReLU MLP [arXiv:2402.16819].
Single-pod training fits only with grad accumulation (16 microbatches) and
bf16 optimizer states — see EXPERIMENTS.md memory analysis."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv=8, head_dim=192,
    d_ff=73728, vocab=256000, act="sq_relu", grad_accum=16,
)
