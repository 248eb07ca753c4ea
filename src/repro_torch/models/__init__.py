"""The model: configs and the stage-structured decoder's entry points (the
reference's exports; ``abstract_params`` and ``abstract_cache`` are meta
tensors where the reference's are ``jax.eval_shape`` trees)."""
from .config import LayerSpec, ModelConfig, Stage
from .model import (abstract_cache, abstract_params, decode_step,
                    forward_train, init_cache, init_params, lm_loss, prefill)

__all__ = [
    "ModelConfig", "LayerSpec", "Stage", "init_params", "abstract_params",
    "init_cache", "abstract_cache", "forward_train", "lm_loss", "prefill",
    "decode_step",
]
