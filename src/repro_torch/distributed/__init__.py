"""Sharding for serving on a device mesh (counterpart of
``repro/distributed``): the serve half of the sharding rules, the
logical activation axes and expert parallelism (``moe_ep``, imported
from its module: it builds on ``models/layers.py``).  The train half,
pipeline parallelism and gradient compression are not ported yet
(ROADMAP.md § A14b)."""
from .sharding import (ParamBlocks, Sharding, Spec, batch_axes_for,
                       cache_specs, param_specs, placement_hint,
                       serve_state_specs, shard_params, shard_serve_state,
                       shardings_of)

__all__ = ["param_specs", "cache_specs", "serve_state_specs",
           "shard_serve_state", "shard_params", "batch_axes_for",
           "placement_hint", "shardings_of", "ParamBlocks", "Sharding", "Spec"]
