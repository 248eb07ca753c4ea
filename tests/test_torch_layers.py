"""``repro_torch/models/layers.py`` against ``repro/models/layers.py`` on
the same numpy inputs.  Tolerance: float32 on both sides with different
summation orders, so 1e-5 absolute and relative (bf16 softmax weights:
1e-2)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def test_rms_norm_scales_by_one_plus_scale():
    rng = np.random.default_rng(0)
    x, s = _rand(rng, 3, 5, 16), _rand(rng, 16)
    _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6))


@pytest.mark.parametrize("per_slot", [False, True])
def test_rope_pairs_halves(per_slot):
    rng = np.random.default_rng(1)
    if per_slot:            # serve path: one position per sequence
        x = _rand(rng, 3, 4, 1, 16)
        pos = np.array([0, 7, 300], np.int32)
        ref = np.stack([np.asarray(jl.rope(jnp.asarray(x[b]),
                                           jnp.asarray(pos[b:b + 1]), 1e6))
                        for b in range(3)])
        got = tl.rope(torch.from_numpy(x),
                      torch.from_numpy(pos)[:, None, None], 1e6)
    else:
        x = _rand(rng, 2, 4, 9, 16)
        pos = np.arange(9, dtype=np.int32)
        ref = jl.rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
        got = tl.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    _close(got, ref)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 3),
                                           (False, 2)])
def test_mask_bias(causal, window):
    qpos, kpos = np.arange(2, 7), np.arange(8)
    ref = jl._mask_bias(jnp.asarray(qpos), jnp.asarray(kpos), causal, window)
    got = tl._mask_bias(torch.from_numpy(qpos), torch.from_numpy(kpos),
                        causal, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert float(got.min()) in (0.0, -2.0 ** 30)


@pytest.mark.parametrize("q_offset,window,valid", [(0, 0, False),
                                                   (4, 3, False),
                                                   (0, 0, True)])
def test_direct_attention(q_offset, window, valid):
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 2, 2, 3, 5, 8), _rand(rng, 2, 2, 9, 8), \
        _rand(rng, 2, 2, 9, 8)
    kv = (np.arange(9)[None] < np.array([[4], [9]])) if valid else None
    ref = jl.direct_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=not valid,
        window=window, q_offset=q_offset,
        kv_valid=None if kv is None else jnp.asarray(kv))
    got = tl.direct_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=not valid, window=window, q_offset=q_offset,
        kv_valid=None if kv is None else torch.from_numpy(kv))
    _close(got, ref)


@pytest.mark.parametrize("kw", [
    dict(causal=True), dict(causal=False), dict(causal=True, window=5),
    dict(causal=True, causal_groups=3), dict(causal=True, q_offset=3),
    dict(causal=True, p_bf16=True)])
def test_chunked_attention(kw):
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 1, 2, 2, 19, 8), _rand(rng, 1, 2, 19, 8), \
        _rand(rng, 1, 2, 19, 8)
    ref = jl.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), chunk_q=4, chunk_k=8, **kw)
    got = tl.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), chunk_q=4, chunk_k=8,
                               **kw)
    tol = dict(atol=1e-2, rtol=1e-2) if kw.get("p_bf16") else TOL
    _close(got, ref, **tol)


@pytest.mark.parametrize("shape", [(1, 9), (600, 1800)])
def test_attention_dispatch(shape):
    """Direct path for small Sq·Sk, chunked beyond 512·2048."""
    sq, sk = shape
    rng = np.random.default_rng(4)
    q, k, v = _rand(rng, 1, 2, sq, 8), _rand(rng, 1, 1, sk, 8), \
        _rand(rng, 1, 1, sk, 8)
    kw = dict(causal=sq > 1, chunk_q=256, chunk_k=512)
    ref = jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = tl.attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), **kw)
    _close(got, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("act", ["swiglu", "sq_relu", "gelu"])
def test_mlp(act):
    rng = np.random.default_rng(5)
    p = {"w1": _rand(rng, 16, 32) / 4, "w2": _rand(rng, 32, 16) / 6,
         "w3": _rand(rng, 16, 32) / 4}
    x = _rand(rng, 3, 1, 16)
    ref = jl.mlp({k: jnp.asarray(w) for k, w in p.items()}, jnp.asarray(x),
                 act)
    got = tl.mlp({k: torch.from_numpy(w) for k, w in p.items()},
                 torch.from_numpy(x), act)
    _close(got, ref)
