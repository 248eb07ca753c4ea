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
projection.  Products compute in their operands' promoted dtype, as
the reference's ``@`` does (``quantized.matmul``).

On a device mesh (inside ``distributed.axes.logical_axes``) the decode
step takes its local-shard form: ``in_x``/``in_gate``/``w_a``/``w_i`` are
column blocks and ``out`` a row block over ``model``, so each rank
updates its block of the width; the gates' dense ``[w, w]`` products take
the whole conv output (one all-gather), and ``out`` ends in one
all-reduce.

Under the train step on a mesh (``axes.train_mesh``) the forward keeps
the activations between collectives whole and the same on every
``model`` rank (``models/tp.py``): the two input branches are column
blocks, the conv runs on the recurrent branch's block (``conv_w`` is cut
on its channels), and both branches are gathered whole in one
all-gather; the gate products by ``w_a``/``w_i``'s column blocks are
gathered whole in another, so the scan runs whole, and ``out`` takes
the recurrence's block through ``split_model``.  Off a train mesh each of
those helpers is the plain op.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..distributed.axes import to_block, to_whole
from .quantized import matmul
from .tp import col_inputs, gather_cols, row_parallel

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


def _gates(params, xb: torch.Tensor, width: int):
    """(a, gated) of the conv output ``xb`` of the whole ``width``.  On a
    mesh ``xb`` may be a block of it: the products take it whole and the
    gates come out as the block of ``w_a``/``w_i``'s columns."""
    xw = to_whole(xb, -1, width)
    r = torch.sigmoid(matmul(xw, params["w_a"])).float()
    i = torch.sigmoid(matmul(xw, params["w_i"])).float()
    lam = to_block(params["lambda_p"], -1, width)
    log_a = -RGLRU_C * F.softplus(lam) * r
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
    w = cfg.rnn_width or cfg.d_model
    xi, xg = col_inputs(x, (params["in_x"], params["in_gate"]), (w, w))
    xb, conv_state = _conv(matmul(xi, params["in_x"]), params["conv_w"])
    xb, gate = gather_cols((xb, matmul(xg, params["in_gate"])), (w, w))
    wa, wi = params["w_a"], params["w_i"]
    xa, xi = col_inputs(xb, (wa, wi), (w, w))
    ra, ri = gather_cols((matmul(xa, wa), matmul(xi, wi)), (w, w))
    r, i = torch.sigmoid(ra).float(), torch.sigmoid(ri).float()
    log_a = -RGLRU_C * F.softplus(params["lambda_p"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xb.float())
    h = linear_scan(a, b)                                      # [B, S, w]
    y = h * F.gelu(gate.float(), approximate="tanh")
    return row_parallel(y.to(x.dtype), params["out"], w), h[:, -1], conv_state


def rglru_decode_step(params, x: torch.Tensor, h: torch.Tensor,
                      conv_state: torch.Tensor, cfg):
    """x [B, 1, d]; h [B, w] → (y [B, 1, d], h', conv_state').  On a
    mesh ``h`` and ``conv_state`` are this rank's width block (a sharded
    pool) or whole (a replicated one), and come back the same way."""
    w = cfg.rnn_width or cfg.d_model
    xb = matmul(x, params["in_x"])                     # a block when cut
    gate = matmul(x, params["in_gate"])
    h_in = to_block(h, -1, w)                          # the block's rows
    xb, conv_new = _conv(xb, params["conv_w"], to_block(conv_state, -1, w))
    a, b = _gates(params, xb, w)                       # [B, 1, w block]
    h_new = a[:, 0] * h_in + b[:, 0]
    y = h_new[:, None] * F.gelu(gate.float(), approximate="tanh")
    out = row_parallel(y.to(x.dtype), params["out"], w)
    if h.shape[-1] == w:                  # a whole (replicated) state
        h_new = to_whole(h_new, -1, w)
        conv_new = to_whole(conv_new, -1, w)
    return out, h_new, conv_new
