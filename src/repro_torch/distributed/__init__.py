"""Sharding on a device mesh (counterpart of ``repro/distributed``): the
sharding rules (train and serve halves), the logical activation axes,
gradient compression (``compression.py``), GPipe pipeline parallelism
(``pipeline.py``) and expert parallelism (``moe_ep``, imported from its
module: it builds on ``models/layers.py``)."""
from .sharding import (ParamBlocks, Sharding, Spec, batch_axes_for,
                       batch_spec, cache_specs, param_specs, placement_hint,
                       serve_state_specs, shard_params, shard_serve_state,
                       shard_state, shardings_of, state_specs)

__all__ = ["param_specs", "state_specs", "batch_spec", "cache_specs",
           "serve_state_specs", "shard_serve_state", "shard_params",
           "shard_state", "batch_axes_for", "placement_hint",
           "shardings_of", "ParamBlocks", "Sharding", "Spec"]
