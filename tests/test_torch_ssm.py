"""``repro_torch/models/ssm.py`` against ``repro/models/ssm.py``: the
mamba2-1.3b smoke config's first Mamba-2 layer (params bridged through
numpy) on inputs drawn from a seeded numpy generator.

  * ``mamba_forward`` at S = 5, 16 and 37 on the smoke ``ssm_chunk`` of
    16: one short chunk (Q = S), one whole chunk, and three chunks with
    the padding; y, the final state and the conv state;
  * ``mamba_decode_step`` from the forward's state, several steps;
  * the shapes the reference hard-codes: ``conv_w`` (4, conv_ch) and a
    3-row decode conv state.

Tolerance: 1e-4 absolute and relative on float32 (two frameworks, other
summation orders through the einsums)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bridged
from repro.models import ssm as js
from repro_torch.models import ssm as ts

TOL = dict(atol=1e-4, rtol=1e-4)
#: the reference functions, compiled once per shape
j_forward = jax.jit(js.mamba_forward, static_argnums=2)
j_decode_step = jax.jit(js.mamba_decode_step, static_argnums=4)


def _params():
    cfg, jp, tp = bridged("mamba2-1.3b")
    return (cfg, {k: v[0] for k, v in jp["stages"][0][0]["mamba"].items()},
            {k: v[0] for k, v in tp["stages"][0][0]["mamba"].items()})


def _close(t, j, what):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL, err_msg=what)


@pytest.mark.parametrize("S", [5, 16, 37])
def test_forward_then_decode_matches_reference(S):
    cfg, jp, tp = _params()
    assert cfg.ssm_chunk == 16
    d_inner, H, P = ts.ssm_dims(cfg)
    assert (d_inner, H, P) == js.ssm_dims(cfg)
    conv_ch = d_inner + 2 * cfg.ssm_state
    assert tp["conv_w"].shape == (4, conv_ch)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jy, jst, jc = j_forward(jp, jnp.asarray(x), cfg)
    ty, tst, tc = ts.mamba_forward(tp, torch.from_numpy(x), cfg)
    _close(ty, jy, "y")
    _close(tst, jst, "final state")
    _close(tc, jc, "conv state")
    assert tst.shape == (2, H, P, cfg.ssm_state)
    assert tc.shape == (2, 3, conv_ch)
    for step in range(4):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jst, jc = j_decode_step(jp, jnp.asarray(xt), jst, jc, cfg)
        ty, tst, tc = ts.mamba_decode_step(tp, torch.from_numpy(xt), tst, tc,
                                           cfg)
        _close(ty, jy, f"decode y, step {step}")
        _close(tst, jst, f"decode state, step {step}")
        _close(tc, jc, f"decode conv state, step {step}")


def test_decode_steps_equal_the_forward():
    """Token by token from a zero state, decode gives the chunked
    forward's outputs and final state (SSD's duality, in the port)."""
    cfg, _, tp = _params()
    d_inner, H, P = ts.ssm_dims(cfg)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(
        rng.standard_normal((1, 21, cfg.d_model)).astype(np.float32))
    y, st_end, c_end = ts.mamba_forward(tp, x, cfg)
    st = torch.zeros((1, H, P, cfg.ssm_state))
    conv = torch.zeros((1, 3, d_inner + 2 * cfg.ssm_state))
    for t in range(21):
        yt, st, conv = ts.mamba_decode_step(tp, x[:, t:t + 1], st, conv, cfg)
        torch.testing.assert_close(yt[:, 0], y[:, t], **TOL)
    torch.testing.assert_close(st, st_end, **TOL)
    torch.testing.assert_close(conv, c_end, **TOL)
