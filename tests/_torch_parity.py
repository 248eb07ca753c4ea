"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
the reference's params bridged to the port through numpy, the reference
model's greedy decode, a page pool without a model, and the fixture that
runs a module's torch ops on one thread."""
import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.launch.serve import serve_config
from repro.models import model as jm
from repro_torch.core.vbi.blocks import PagePool
from repro_torch.models import model as tm


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a test module's torch ops on one intra-op thread, restoring the
    count after it.  The suite runs six pytest-xdist workers on the
    machine's cores, and torch's default of one thread per core in each
    makes the small ops of these tests contend: a file of disaggregated
    serves took 462 s that way and well under a minute on one thread.
    A module imports this fixture by name to turn it on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@lru_cache(maxsize=None)
def bridged(arch: str):
    """(cfg, JAX params, port params on the CPU) for ``arch``'s float32
    smoke serve config, built once per test process."""
    cfg = serve_config(arch)
    jp = jm.init_params(cfg, jax.random.key(0))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


@lru_cache(maxsize=None)
def _smoke_params(arch: str):
    jp = jm.init_params(smoke_config(arch), jax.random.key(0))
    return jp, tm.params_from_numpy(jax.tree.map(np.asarray, jp),
                                    device="cpu")


def bridged_smoke(arch: str, compute_dtype: str = "float32"):
    """(cfg, JAX params, port params on the CPU) for ``arch``'s smoke
    config (not the serve config, which turns whisper into a decoder-only
    stack) at ``compute_dtype``; the params (float32, which the compute
    dtype does not change) are built once per test process and shared:
    a test must not update them in place."""
    cfg = dataclasses.replace(smoke_config(arch), compute_dtype=compute_dtype)
    return (cfg, *_smoke_params(arch))


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


def Pool(n_pages, page_size, max_seqs, max_pages):
    """The engine's pool protocol without a model: a one-layer CPU
    ``PagePool``, for driving a ``VBIAllocator`` alone."""
    return PagePool(n_layers=1, n_pages=n_pages, page_size=page_size,
                    n_kv=1, head_dim=2, max_seqs=max_seqs,
                    max_pages_per_seq=max_pages, device="cpu")
