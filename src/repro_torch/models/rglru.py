"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Counterpart of ``repro/models/rglru.py``.  Real-Gated Linear Recurrent
Unit:

    r_t = σ(W_a x_t)            (recurrence gate)
    i_t = σ(W_x x_t)            (input gate)
    a_t = exp(-c · softplus(Λ) · r_t)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

Training and prefill run the linear recurrence as a log-depth
Hillis–Steele scan of elementwise ops over the sequence (where the
reference uses ``lax.associative_scan``); decode is the O(1) update.

Block structure (Griffin temporal block): linear in (2 branches), causal
conv(``conv_width``) on the recurrent branch, RG-LRU, gated output
projection.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

RGLRU_C = 8.0


def init_rglru_params(cfg, ini, n: int, dtype) -> Dict:
    """``n`` layers' RG-LRU leaves, stacked along a leading ``[n]`` axis,
    drawn from the model's ``_Init`` (the reference's shapes and scales)."""
    d = cfg.d_model
    w = cfg.rnn_width or d
    s = d ** -0.5
    return {
        "in_x": ini.normal((n, d, w), s, dtype),
        "in_gate": ini.normal((n, d, w), s, dtype),
        "conv_w": ini.normal((n, cfg.conv_width, w), 0.2, dtype),
        "w_a": ini.normal((n, w, w), w ** -0.5, dtype),
        "w_i": ini.normal((n, w, w), w ** -0.5, dtype),
        "lambda_p": ini.full((n, w), 0.5, torch.float32),
        "out": ini.normal((n, w, d), w ** -0.5, dtype),
    }


def _conv(x: torch.Tensor, conv_w: torch.Tensor, conv_state=None):
    """Depthwise causal conv over x [B, S, w]: zero history in training,
    ``conv_state`` [B, width - 1, w] in decode → (out, new state)."""
    w = conv_w.shape[0]
    if conv_state is None:
        pad = F.pad(x, (0, 0, w - 1, 0))
    else:
        pad = torch.cat([conv_state, x], dim=1)
    S = x.shape[1]
    out = sum(pad[:, i:i + S] * conv_w[i][None, None] for i in range(w))
    return out, pad[:, -(w - 1):]


def _gates(params, xb: torch.Tensor):
    r = torch.sigmoid(xb @ params["w_a"]).float()
    i = torch.sigmoid(xb @ params["w_i"]).float()
    log_a = -RGLRU_C * F.softplus(params["lambda_p"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) \
        * (i * xb.float())
    return a, gated


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t · h_{t-1} + b_t with h_{-1} = 0 along axis 1, as
    ceil(log2 S) rounds of elementwise ops (Hillis–Steele): after the
    round of offset o, (a_t, b_t) compose the steps (t - 2o, t]."""
    S = a.shape[1]
    off = 1
    while off < S:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def rglru_forward(params, x: torch.Tensor, cfg):
    """x [B, S, d] → (y [B, S, d], h_final [B, w], conv_state)."""
    xb = x @ params["in_x"]
    gate = x @ params["in_gate"]
    xb, conv_state = _conv(xb, params["conv_w"])
    a, b = _gates(params, xb)                          # [B, S, w] f32
    h = linear_scan(a, b)
    y = h * F.gelu(gate.float(), approximate="tanh")
    return y.to(x.dtype) @ params["out"], h[:, -1], conv_state


def rglru_decode_step(params, x: torch.Tensor, h: torch.Tensor,
                      conv_state: torch.Tensor, cfg):
    """x [B, 1, d]; h [B, w] → (y [B, 1, d], h', conv_state')."""
    xb = x @ params["in_x"]
    gate = x @ params["in_gate"]
    xb, conv_state = _conv(xb, params["conv_w"], conv_state)
    a, b = _gates(params, xb)                          # [B, 1, w]
    h = a[:, 0] * h + b[:, 0]
    y = h[:, None] * F.gelu(gate.float(), approximate="tanh")
    return y.to(x.dtype) @ params["out"], h, conv_state
