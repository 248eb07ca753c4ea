"""``repro_torch/models/layers.py::moe`` / ``_moe_local`` against the
reference's local grouped path (``repro/models/layers.py``), on the
mixtral-8x7b and qwen3-moe-235b-a22b smoke configs' first MoE layer
(params bridged through numpy) and tokens drawn from a seeded numpy
generator.

  * T = 2 and 8 (one token per group: no token can be dropped) and T = 64
    (G 32, Tg 2; at top-k 2 cap 1): there the test first shows from the
    router that some (token, expert) pairs exceed their capacity, so the
    stable sort decides which pair is dropped, and the outputs must still
    agree;
  * top-k 2 (both smoke configs) and 3 (a fixed-order sum of more than two
    expert outputs per token; cap 2 at T = 64);
  * ``moe`` on [B, S, d] equals ``_moe_local`` on the flattened tokens.

Tolerance: 1e-4 absolute and relative on float32 (two frameworks, other
summation orders through the expert einsums)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bridged, one_torch_thread
from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = dict(atol=1e-4, rtol=1e-4)
#: the reference's local path, compiled once per shape
j_moe_local = jax.jit(jl._moe_local, static_argnums=2)


def _params(arch):
    cfg, jp, tp = bridged(arch)
    assert cfg.stages()[0].period[0].moe
    return (cfg, {k: v[0] for k, v in jp["stages"][0][0]["moe"].items()},
            {k: v[0] for k, v in tp["stages"][0][0]["moe"].items()})


def _over_capacity(cfg, params, x):
    """(token, choice) pairs routed past their expert's capacity, counted
    from the router alone (numpy)."""
    T = x.shape[0]
    G = tl._moe_groups(T, cfg.moe_groups)
    Tg = T // G
    cap = int(max(1, round(Tg * cfg.top_k / cfg.n_experts
                           * cfg.capacity_factor)))
    logits = x.reshape(G, Tg, -1) @ np.asarray(params["router"])
    top = np.argsort(-logits, axis=-1)[..., :cfg.top_k].reshape(G, -1)
    counts = np.stack([np.bincount(r, minlength=cfg.n_experts) for r in top])
    return int(np.clip(counts - cap, 0, None).sum())


@pytest.mark.parametrize("top_k", [2, 3])
@pytest.mark.parametrize("T", [2, 8, 64])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-235b-a22b"])
def test_moe_local_matches_reference(arch, T, top_k):
    cfg, jp, tp = _params(arch)
    cfg = dataclasses.replace(cfg, top_k=top_k)
    rng = np.random.default_rng(T * 10 + top_k)
    x = rng.standard_normal((T, cfg.d_model)).astype(np.float32)
    dropped = _over_capacity(cfg, jp, x)
    if T < 64:                      # one token per group
        assert dropped == 0
    elif top_k == 2:                # G 32, Tg 2, cap 1
        assert tl._moe_groups(T, cfg.moe_groups) == 32
        assert dropped > 0, "the case must drop a token"
    want = np.asarray(j_moe_local(jp, jnp.asarray(x), cfg))
    got = tl._moe_local(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, tl._moe_local(tp, torch.from_numpy(x), cfg))


def test_moe_on_batch_is_local_path_on_tokens():
    cfg, _, tp = _params("mixtral-8x7b")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(
        rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32))
    torch.testing.assert_close(
        tl.moe(tp, x, cfg),
        tl._moe_local(tp, x.reshape(6, -1), cfg).reshape(2, 3, -1),
        atol=0, rtol=0)
