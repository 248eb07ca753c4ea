"""InternVL2-26B backbone: InternViT frontend (STUB: precomputed patch
embeddings) + InternLM2-20B-style decoder [arXiv:2404.16821; hf].
Vocab padded 92553 -> 92672 for clean TP sharding."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv=8, head_dim=128,
    d_ff=16384, vocab=92672, n_vis_tokens=256,
    rope_theta=1e6, grad_accum=4,
)
