"""Whisper-small backbone: encoder-decoder transformer; conv/audio frontend
is a STUB (input_specs provides precomputed 1500-frame embeddings)
[arXiv:2212.04356]. Vocab padded 51865 -> 51968."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv=12, head_dim=64,
    d_ff=3072, vocab=51968, act="gelu",
    n_enc_layers=12, n_audio_frames=1500,
)
