"""The model: configs and the stage-structured decoder's entry points (the
reference's exports, less ``abstract_params``/``abstract_cache``, which
rest on ``jax.eval_shape``: ROADMAP.md § A15b)."""
from .config import LayerSpec, ModelConfig, Stage
from .model import (decode_step, forward_train, init_cache, init_params,
                    lm_loss, prefill)

__all__ = [
    "ModelConfig", "LayerSpec", "Stage", "init_params", "init_cache",
    "forward_train", "lm_loss", "prefill", "decode_step",
]
