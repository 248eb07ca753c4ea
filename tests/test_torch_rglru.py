"""``repro_torch/models/rglru.py`` against ``repro/models/rglru.py``: the
recurrentgemma-9b smoke config's first RG-LRU layer (params bridged
through numpy) on inputs drawn from a seeded numpy generator.

  * ``rglru_forward`` at S = 1, 7 and 33 (the log-depth scan's rounds
    below, at and past a power of two): y, the final h and the conv state;
  * ``rglru_decode_step`` from the forward's state, several steps: y, h
    and the conv state at each;
  * the scan itself against a sequential loop.

Tolerance: 1e-4 absolute and relative on float32 (two frameworks, the
scan composed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bridged
from repro.models import rglru as jr
from repro_torch.models import rglru as tr

TOL = dict(atol=1e-4, rtol=1e-4)
#: the reference functions, compiled once per shape
j_forward = jax.jit(jr.rglru_forward, static_argnums=2)
j_decode_step = jax.jit(jr.rglru_decode_step, static_argnums=4)


def _layer(tree, j=0):
    return {k: v[j] for k, v in tree.items()}


def _params():
    cfg, jp, tp = bridged("recurrentgemma-9b")
    assert cfg.stages()[0].period[0].kind == "rglru"
    return (cfg, _layer(jp["stages"][0][0]["rglru"]),
            _layer(tp["stages"][0][0]["rglru"]))


def _close(t, j, what):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL, err_msg=what)


@pytest.mark.parametrize("S", [1, 7, 33])
def test_forward_then_decode_matches_reference(S):
    cfg, jp, tp = _params()
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jy, jh, jc = j_forward(jp, jnp.asarray(x), cfg)
    ty, th, tc = tr.rglru_forward(tp, torch.from_numpy(x), cfg)
    _close(ty, jy, "y")
    _close(th, jh, "h")
    _close(tc, jc, "conv state")
    assert tc.shape == (2, cfg.conv_width - 1, cfg.rnn_width)
    for step in range(4):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jh, jc = j_decode_step(jp, jnp.asarray(xt), jh, jc, cfg)
        ty, th, tc = tr.rglru_decode_step(tp, torch.from_numpy(xt), th, tc,
                                          cfg)
        _close(ty, jy, f"decode y, step {step}")
        _close(th, jh, f"decode h, step {step}")
        _close(tc, jc, f"decode conv state, step {step}")


def test_decode_steps_equal_the_forward():
    """Token by token from a zero state, decode gives the forward's
    outputs and final state (the recurrence and conv carried exactly)."""
    cfg, _, tp = _params()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(
        rng.standard_normal((1, 9, cfg.d_model)).astype(np.float32))
    y, h_end, c_end = tr.rglru_forward(tp, x, cfg)
    w = cfg.rnn_width
    h = torch.zeros((1, w))
    conv = torch.zeros((1, cfg.conv_width - 1, w))
    for t in range(9):
        yt, h, conv = tr.rglru_decode_step(tp, x[:, t:t + 1], h, conv, cfg)
        torch.testing.assert_close(yt[:, 0], y[:, t], **TOL)
    torch.testing.assert_close(h, h_end, **TOL)
    torch.testing.assert_close(conv, c_end, **TOL)


@pytest.mark.parametrize("S", [1, 2, 5, 16, 33])
def test_linear_scan_matches_sequential_loop(S):
    rng = np.random.default_rng(S)
    a = torch.from_numpy(rng.uniform(0, 1, (2, S, 3)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, S, 3)).astype(np.float32))
    h = torch.zeros((2, 3))
    want = []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(tr.linear_scan(a, b), torch.stack(want, 1),
                               atol=1e-6, rtol=1e-6)
