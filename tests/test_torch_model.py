"""``repro_torch/models/model.py`` against ``repro/models/model.py``: the
same params (bridged through numpy) and prompts give the same prefill and
decode logits, caches and the same greedy tokens on the qwen3-0.6b
(qk-norm, tied embeddings), qwen2.5-3b (QKV bias) and nemotron-4-340b
(squared ReLU) smoke configs, and on the mixed stacks: gemma3-12b
(5 local : 1 global), recurrentgemma-9b (RG-LRU, RG-LRU, local),
mamba2-1.3b (Mamba-2 only), mixtral-8x7b (sliding window, top-2 MoE) and
qwen3-moe-235b-a22b (top-k MoE).  The prompt and the decode run past the
smoke window of 16, so the ring caches wrap.  Tolerance: 1e-4 absolute and relative on float32 logits
(two frameworks, different summation orders through the layer stack)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bridged, jax_decode_step
from repro.models import model as jm
from repro_torch.models import model as tm

TOL = dict(atol=1e-4, rtol=1e-4)


MIXED = ["gemma3-12b", "recurrentgemma-9b", "mamba2-1.3b", "mixtral-8x7b",
         "qwen3-moe-235b-a22b"]


def _same_caches(jc, tc, what):
    """Every cache leaf of every stage and period entry (K/V, recurrent
    state, conv state)."""
    for si, (j_stage, t_stage) in enumerate(zip(jc, tc)):
        for i, (j_ent, t_ent) in enumerate(zip(j_stage, t_stage)):
            assert t_ent.keys() == j_ent.keys()
            for name in j_ent:
                np.testing.assert_allclose(
                    t_ent[name].numpy(), np.asarray(j_ent[name]), **TOL,
                    err_msg=f"{what}: stage {si} entry {i} {name}")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2.5-3b",
                                  "nemotron-4-340b"] + MIXED)
def test_prefill_decode_logits_and_greedy_tokens(arch):
    cfg, jp, tp = bridged(arch)
    rng = np.random.default_rng(7)
    n = 6 if arch not in MIXED else 13
    toks = rng.integers(0, cfg.vocab, (2, n)).astype(np.int32)
    max_len = n + 8
    jl, jc = jm.prefill(cfg, jp, {"tokens": jnp.asarray(toks)}, max_len)
    tl, tc = tm.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)}, max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _same_caches(jc, tc, "prefill")
    j_nxt = np.asarray(jnp.argmax(jl[:, 0], -1))
    t_nxt = j_nxt.copy()
    for pos in range(n, max_len):
        jl, jc = jax_decode_step(cfg, jp, jc, jnp.asarray(j_nxt)[:, None],
                                 jnp.int32(pos))
        tl, tc = tm.decode_step(cfg, tp, tc,
                                torch.from_numpy(t_nxt)[:, None], pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"pos {pos}")
        j_nxt = np.asarray(jnp.argmax(jl[:, 0], -1))
        t_nxt = tl[:, 0].argmax(-1).numpy()
        np.testing.assert_array_equal(t_nxt, j_nxt)
    _same_caches(jc, tc, "decode")


def test_windowed_decode_keeps_ring_tail():
    """A sliding-window config keeps only the last ``window`` tokens in a
    ring cache, in prefill and decode alike."""
    import dataclasses
    cfg, jp, tp = bridged("qwen3-0.6b")
    cfg = dataclasses.replace(cfg, window=4)
    toks = np.arange(1, 7, dtype=np.int32)[None]
    jl, jc = jm.prefill(cfg, jp, {"tokens": jnp.asarray(toks)}, 10)
    tl, tc = tm.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)}, 10)
    np.testing.assert_allclose(tc[0][0]["k"].numpy(),
                               np.asarray(jc[0][0]["k"]), **TOL)
    for pos in (6, 7):
        jl, jc = jm.decode_step(cfg, jp, jc, jnp.asarray([[3]]),
                                jnp.int32(pos))
        tl, tc = tm.decode_step(cfg, tp, tc, torch.tensor([[3]]), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
