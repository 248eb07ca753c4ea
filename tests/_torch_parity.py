"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
the reference's params bridged to the port through numpy, and the
reference model's greedy decode."""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from repro.launch.serve import serve_config
from repro.models import model as jm
from repro_torch.models import model as tm


@lru_cache(maxsize=None)
def bridged(arch: str):
    """(cfg, JAX params, port params on the CPU) for ``arch``'s float32
    smoke serve config, built once per test process."""
    cfg = serve_config(arch)
    jp = jm.init_params(cfg, jax.random.key(0))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


#: the reference decode step, compiled once per cache shape
jax_decode_step = jax.jit(jm.decode_step, static_argnums=0)


def jax_greedy(cfg, params, prompt, max_new):
    """The reference model's greedy decode of one prompt."""
    logits, caches = jm.prefill(cfg, params,
                                {"tokens": jnp.asarray([prompt], jnp.int32)},
                                len(prompt) + max_new)
    out = [int(jnp.argmax(logits[0, 0]))]
    for pos in range(len(prompt), len(prompt) + max_new - 1):
        logits, caches = jax_decode_step(
            cfg, params, caches, jnp.asarray([[out[-1]]], jnp.int32),
            jnp.int32(pos))
        out.append(int(jnp.argmax(logits[0, 0])))
    return out
