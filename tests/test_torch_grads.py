"""``repro_torch/models/model.py::lm_loss`` and its gradients against the
reference's ``lm_loss`` under ``jax.value_and_grad``, and the port's remat:

  * float32 compute, on the smoke configs of qwen3-0.6b, gemma3-12b,
    mixtral-8x7b (top-2 MoE with capacity drops), recurrentgemma-9b,
    mamba2-1.3b, whisper-small (encoder and cross-attention) and
    internvl2-26b (the vision slice): loss within 1e-5 absolute; each
    gradient leaf within 2e-5 of that leaf's largest magnitude (float32
    backward passes summed in other orders; measured at most 3.5e-6);
  * the configs' own bfloat16 compute with float32 params (the products
    promote to float32, as in JAX): the loss within 1e-3 absolute of a
    loss near 6 — bfloat16 keeps 8 bits, so a value rounded the other way
    in one framework moves a logit by up to 2^-8 of it (readings 0 to
    3.2e-4, gemma3-12b the largest).  A fresh model's loss barely moves
    with precision (the reference's own float32 and bfloat16 losses are
    8e-5 apart for internvl2-26b), so the logits are held too: the
    port's mean absolute distance from the reference's bfloat16 logits
    is under half the distance of the reference's float32 logits from
    them.  The readings: at most 0.19 of it (gemma3-12b; 0 to 0.07 for
    the others); the port at float32 compute reads about 1.0 of it, so
    a port that ignored ``compute_dtype`` fails;
  * remat off, on (``"nothing"``) and ``"dots"`` give bit-equal losses and
    gradients (recomputation replays the same ops); with remat every
    decoder layer runs under ``torch.utils.checkpoint`` and the backward
    replays each layer's 2-D matmuls, with ``"dots"`` none; under
    ``torch.no_grad`` nothing is checkpointed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_parity import bridged_smoke, one_torch_thread
from repro.data.pipeline import SyntheticLMData
from repro.models import model as jm
from repro_torch.models import model as tm
from repro_torch.train.step import _value_and_grad
from repro_torch.tree import leaves, tree_map

ARCHS = ["qwen3-0.6b", "gemma3-12b", "mixtral-8x7b", "recurrentgemma-9b",
         "mamba2-1.3b", "whisper-small", "internvl2-26b"]
B, S_TEXT = 2, 20


def _batch(cfg):
    return SyntheticLMData(cfg, B, cfg.n_vis_tokens + S_TEXT, 0).batch_at(0)


def _port_loss(cfg):
    return lambda p, b: tm.lm_loss(cfg, p, b)


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    cfg, jp, tp = bridged_smoke(arch)
    b = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p, bb: jm.lm_loss(cfg, p, bb)))(jp, jb)
    t_loss, t_grads = _value_and_grad(_port_loss(cfg), tp, _torch(b))
    assert abs(float(j_loss) - float(t_loss)) < 1e-5
    want = [np.asarray(g) for g in jax.tree.leaves(j_grads)]
    got = leaves(t_grads)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2e-5 * np.abs(w).max() + 1e-12,
                                   err_msg=f"leaf {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_at_bf16_compute_matches_reference(arch):
    cfg, jp, tp = bridged_smoke(arch, "bfloat16")
    assert cfg.compute_dtype == "bfloat16" and cfg.param_dtype == "float32"
    b = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want = float(jm.lm_loss(cfg, jp, jb))
    got = tm.lm_loss(cfg, tp, _torch(b))
    assert got.dtype == torch.float32 and np.isfinite(want)
    assert abs(float(got) - want) < 1e-3
    j16 = np.asarray(jm.forward_train(cfg, jp, jb), np.float32)
    j32 = np.asarray(jm.forward_train(
        dataclasses.replace(cfg, compute_dtype="float32"), jp, jb),
        np.float32)
    with torch.no_grad():
        t16 = tm.forward_train(cfg, tp, _torch(b)).float().numpy()
    assert np.abs(t16 - j16).mean() < 0.5 * np.abs(j32 - j16).mean()


def _grads(cfg, tp, b):
    loss, grads = _value_and_grad(_port_loss(cfg), tp, b)
    return loss, leaves(grads)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b",
                                  "recurrentgemma-9b", "whisper-small"])
def test_remat_changes_memory_only(arch):
    cfg, _, tp = bridged_smoke(arch)
    b = _torch(_batch(cfg))
    base = _grads(dataclasses.replace(cfg, remat=False), tp, b)
    for policy in ("nothing", "dots"):
        got = _grads(dataclasses.replace(cfg, remat=True,
                                         remat_policy=policy), tp, b)
        assert torch.equal(got[0], base[0]), policy
        assert all(torch.equal(g, w) for g, w in zip(got[1], base[1])), \
            policy


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _backward_matmuls(cfg, tp, b):
    """2-D matmuls run by the backward of one loss."""
    params = tree_map(lambda t: t.detach().requires_grad_(True), tp)
    loss = tm.lm_loss(cfg, params, b)
    with _CountMM() as count:
        loss.backward()
    return count.n


def test_remat_policies_recompute_what_they_say(monkeypatch):
    cfg, _, tp = bridged_smoke("qwen3-0.6b")
    b = _torch(_batch(cfg))
    n = {label: _backward_matmuls(
        dataclasses.replace(cfg, remat=remat, remat_policy=policy), tp, b)
        for label, remat, policy in (("off", False, "nothing"),
                                     ("nothing", True, "nothing"),
                                     ("dots", True, "dots"))}
    # "nothing" replays each layer's projections up to the last one whose
    # output the backward needs (q, k, v, o, w1, w3: six of seven; the
    # non-reentrant checkpoint stops the replay there); "dots" replays
    # none of them
    assert n["nothing"] == n["off"] + 6 * cfg.n_layers
    assert n["dots"] == n["off"]
    calls = []
    real = tm.torch_checkpoint.checkpoint
    monkeypatch.setattr(tm.torch_checkpoint, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rcfg = dataclasses.replace(cfg, remat=True)
    _value_and_grad(_port_loss(rcfg), tp, b)
    assert len(calls) == cfg.n_layers
    with torch.no_grad():
        tm.lm_loss(rcfg, tp, b)
    assert len(calls) == cfg.n_layers
