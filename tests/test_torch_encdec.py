"""The encoder-decoder (whisper-small) and vision (internvl2-26b) paths of
``repro_torch/models/model.py`` against ``repro/models/model.py``, on the
two smoke configs at float32 compute with the reference's params bridged
through numpy:

  * ``forward_train`` logits and the encoder's output;
  * ``prefill`` logits and every cache leaf (the cross-attention's
    ``xk``/``xv`` included), then two ``decode_step`` calls' logits and
    caches, each fed the greedy token; the greedy tokens are equal;
  * the port's own prefill + decode equal its ``forward_train`` at the
    same positions (the reference's teacher-forcing check,
    ``tests/test_models.py::test_decode_matches_teacher_forcing``);
  * ``init_cache`` gives the reference's leaves, shapes and dtypes.

Tolerance: 1e-4 absolute and relative on float32 logits and caches, as in
``tests/test_torch_model.py`` (two frameworks, different summation orders
through the stack); the teacher-forcing check keeps the reference's
2e-3 / 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bridged_smoke, one_torch_thread
from repro.data.pipeline import SyntheticLMData
from repro.models import model as jm
from repro_torch.models import model as tm

TOL = dict(atol=1e-4, rtol=1e-4)
TF_TOL = dict(atol=2e-3, rtol=1e-3)
ARCHS = ["whisper-small", "internvl2-26b"]
B, S = 2, 12


def _batch(cfg, n_text, seed=0):
    """The reference's synthetic batch of ``n_text`` text tokens (and
    labels, and the config's audio frames or vision embeddings) as
    numpy."""
    b = SyntheticLMData(cfg, B, cfg.n_vis_tokens + n_text, seed).batch_at(0)
    assert b["tokens"].shape == (B, n_text)
    return b


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _same_caches(jc, tc, what):
    for si, (j_stage, t_stage) in enumerate(zip(jc, tc)):
        for i, (j_ent, t_ent) in enumerate(zip(j_stage, t_stage)):
            assert t_ent.keys() == j_ent.keys()
            for name in j_ent:
                np.testing.assert_allclose(
                    t_ent[name].numpy(), np.asarray(j_ent[name]), **TOL,
                    err_msg=f"{what}: stage {si} entry {i} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch):
    cfg, jp, tp = bridged_smoke(arch)
    b = _batch(cfg, S)
    want = np.asarray(jm.forward_train(cfg, jp, _jax(b)))
    got = tm.forward_train(cfg, tp, _torch(b))
    assert got.shape == want.shape == (B, S + cfg.n_vis_tokens, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_encoder_output_matches_reference():
    cfg, jp, tp = bridged_smoke("whisper-small")
    frames = _batch(cfg, S)["audio_frames"]
    assert frames.shape == (B, cfg.n_audio_frames, cfg.d_model)
    want = np.asarray(jm._run_encoder(cfg, jp, jnp.asarray(frames)))
    got = tm._run_encoder(cfg, tp, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_caches_and_greedy_tokens(arch):
    cfg, jp, tp = bridged_smoke(arch)
    b = _batch(cfg, S)
    b = {k: v for k, v in b.items() if k != "labels"}
    max_len = cfg.n_vis_tokens + S + 4
    jl, jc = jm.prefill(cfg, jp, _jax(b), max_len)
    tl, tc = tm.prefill(cfg, tp, _torch(b), max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _same_caches(jc, tc, "prefill")
    if cfg.is_encdec:
        assert tc[0][0]["xk"].abs().sum() > 0     # filled, not the zeros
    j_nxt = np.asarray(jnp.argmax(jl[:, 0], -1))
    t_nxt = tl[:, 0].argmax(-1).numpy()
    np.testing.assert_array_equal(t_nxt, j_nxt)
    for pos in range(cfg.n_vis_tokens + S, cfg.n_vis_tokens + S + 2):
        jl, jc = jm.decode_step(cfg, jp, jc, jnp.asarray(j_nxt)[:, None],
                                jnp.int32(pos))
        tl, tc = tm.decode_step(cfg, tp, tc,
                                torch.from_numpy(t_nxt)[:, None], pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"pos {pos}")
        j_nxt = np.asarray(jnp.argmax(jl[:, 0], -1))
        t_nxt = tl[:, 0].argmax(-1).numpy()
        np.testing.assert_array_equal(t_nxt, j_nxt)
    _same_caches(jc, tc, "decode")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """prefill + decode == forward_train at the same positions."""
    cfg, _, tp = bridged_smoke(arch)
    full = _torch(_batch(cfg, S + 1))
    pre = {k: (v[:, :S] if k in ("tokens", "labels") else v)
           for k, v in full.items()}
    logits = tm.forward_train(cfg, tp, full)
    lg_pre, caches = tm.prefill(cfg, tp, pre,
                                max_len=cfg.n_vis_tokens + S + 4)
    lg_dec, _ = tm.decode_step(cfg, tp, caches,
                               full["tokens"][:, S:S + 1],
                               cfg.n_vis_tokens + S)
    off = cfg.n_vis_tokens
    torch.testing.assert_close(lg_pre[:, 0], logits[:, off + S - 1],
                               **TF_TOL)
    torch.testing.assert_close(lg_dec[:, 0], logits[:, off + S], **TF_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    cfg, _, _ = bridged_smoke(arch)
    want = jm.init_cache(cfg, B, 20)
    got = tm.init_cache(cfg, B, 20, device="cpu")
    for j_stage, t_stage in zip(want, got, strict=True):
        for j_ent, t_ent in zip(j_stage, t_stage, strict=True):
            assert t_ent.keys() == j_ent.keys()
            for name in j_ent:
                assert tuple(t_ent[name].shape) == j_ent[name].shape, name
                assert str(t_ent[name].dtype).removeprefix("torch.") \
                    == str(j_ent[name].dtype), name
    if cfg.is_encdec:
        assert got[0][0]["xk"].shape == (cfg.n_layers, B, cfg.n_kv,
                                         cfg.n_audio_frames, cfg.head_dim)
