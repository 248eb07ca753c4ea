"""RecurrentGemma-9B (Griffin): RG-LRU + local attention, pattern
(recurrent, recurrent, local-attn) [arXiv:2402.19427]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv=1, head_dim=256,
    d_ff=12288, vocab=256000, rglru_period=3, rnn_width=4096,
    local_window=2048,
)
