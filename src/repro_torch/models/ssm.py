"""Mamba-2 (SSD — state-space duality) temporal mixer.

Counterpart of ``repro/models/ssm.py``.  Chunked SSD algorithm (Dao & Gu
2024): an intra-chunk quadratic attention-like term plus an inter-chunk
linear recurrence over states, here a loop over chunks where the
reference scans.  Decode is the O(1) recurrent update; there is no KV
cache, only a constant-size state per sequence.

Shapes: d_inner = expand·d_model = H·P heads; B/C projections share one
group (G=1); state size N.  As in the reference, the causal conv is 4
wide whatever ``cfg.conv_width`` says, so the decode conv state holds 3
rows.  Products compute in their operands' promoted dtype, as the
reference's ``@`` does (``quantized.matmul``).

On a device mesh (inside ``distributed.axes.logical_axes``) the decode
step takes its local-shard form.  A column block of ``in_proj`` cuts
across its ``z | xBC | dt`` segments, so the projection is all-gathered
whole; the conv runs on ``conv_w``'s channel block and is gathered back;
the recurrence runs on the state's heads (a block in a sharded pool, all
of them in a replicated one); the gated norm spans all of ``d_inner``, so
``y`` is gathered before it, and ``out_proj``'s row block ends in one
all-reduce.

Under the train step on a mesh (``axes.train_mesh``) the forward keeps
the activations between collectives whole and the same on every
``model`` rank (``models/tp.py``): ``in_proj``'s column block of the
product is gathered whole before the split, ``conv_w``'s channel block
is gathered whole, so the conv, the chunked scan, ``D`` and the gated
norm run whole, and ``out_proj`` takes ``y``'s block through
``split_model`` (a row block).  Off a train mesh each of those helpers
is the plain op.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..distributed.axes import to_block, to_whole
from .quantized import matmul
from .tp import col_input, gather_cols, row_parallel


def ssm_dims(cfg) -> Tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads or d_inner // (cfg.ssm_head_dim or 64)
    P = d_inner // H
    return d_inner, H, P


def init_mamba_params(cfg, ini, n: int, dtype) -> Dict:
    """``n`` layers' Mamba-2 leaves, stacked along a leading ``[n]`` axis,
    drawn from the model's ``_Init`` (the reference's shapes and scales)."""
    d = cfg.d_model
    d_inner, H, P = ssm_dims(cfg)
    N = cfg.ssm_state
    conv_ch = d_inner + 2 * N
    return {
        "in_proj": ini.normal((n, d, 2 * d_inner + 2 * N + H), d ** -0.5,
                              dtype),
        "conv_w": ini.normal((n, 4, conv_ch), 0.2, dtype),
        "A_log": ini.zeros((n, H), torch.float32),
        "D": ini.full((n, H), 1.0, torch.float32),
        "dt_bias": ini.zeros((n, H), torch.float32),
        "norm": ini.zeros((n, d_inner), torch.float32),
        "out_proj": ini.normal((n, d_inner, d), d_inner ** -0.5, dtype),
    }


def _split_proj(cfg, proj: torch.Tensor):
    d_inner, H, P = ssm_dims(cfg)
    N = cfg.ssm_state
    return torch.split(proj, [d_inner, d_inner + 2 * N, H], dim=-1)


def _conv(xBC: torch.Tensor, conv_w: torch.Tensor, conv_state=None):
    """Depthwise causal conv width 4.  Training: pad-left; decode: state."""
    w = conv_w.shape[0]
    if conv_state is None:
        pad = F.pad(xBC, (0, 0, w - 1, 0))
    else:
        pad = torch.cat([conv_state, xBC], dim=1)
    S = xBC.shape[1]
    out = sum(pad[:, i:i + S] * conv_w[i][None, None] for i in range(w))
    return F.silu(out), pad[:, -(w - 1):]


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    dt = y.dtype
    y = y.float() * F.silu(z.float())
    y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + eps)
    return (y * (1.0 + scale)).to(dt)


def mamba_forward(params, x: torch.Tensor, cfg):
    """Training/prefill: x [B, S, d] → (y [B, S, d], final_state
    [B, H, P, N], conv_state [B, 3, conv_ch])."""
    Bsz, S, d = x.shape
    d_inner, H, P = ssm_dims(cfg)
    N = cfg.ssm_state
    Q = min(cfg.ssm_chunk, S)
    pad = (-S) % Q
    n_proj = 2 * d_inner + 2 * N + H
    w_in = params["in_proj"]
    proj = gather_cols((matmul(col_input(x, w_in, n_proj), w_in),),
                       (n_proj,))[0]
    z, xBC, dt_raw = _split_proj(cfg, proj)
    conv_w = gather_cols((params["conv_w"],), (d_inner + 2 * N,))[0]
    xBC, conv_state = _conv(xBC, conv_w)
    xs, B, C = torch.split(xBC, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])     # [B,S,H]
    A = -torch.exp(params["A_log"])                         # [H]

    if pad:
        xs, B, C, dt = (F.pad(t, (0, 0, 0, pad)) for t in (xs, B, C, dt))
    Sp = S + pad
    nc = Sp // Q
    xh = xs.reshape(Bsz, nc, Q, H, P).float()
    Bc = B.reshape(Bsz, nc, Q, N).float()
    Cc = C.reshape(Bsz, nc, Q, N).float()
    dtc = dt.reshape(Bsz, nc, Q, H)
    dA = dtc * A                                            # [B,nc,Q,H]
    seg = torch.cumsum(dA, dim=2)                           # [B,nc,Q,H]

    # intra-chunk (quadratic within Q).  Masked before the exp: above the
    # diagonal rel is the decay's inverse, which overflows at a long chunk
    # (the published 256), and the gradient of where(causal, exp(rel), 0)
    # is then 0 x inf = NaN there (the reference's fault, ROADMAP.md § C6)
    rel = seg[:, :, :, None] - seg[:, :, None]              # [B,nc,Q,Q,H]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    L = torch.exp(torch.where(causal[None, None, :, :, None], rel,
                              float("-inf")))
    CB = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)            # [B,nc,Q,Q]
    M = CB[..., None] * L                                   # [B,nc,Q,Q,H]
    y_diag = torch.einsum("bcqkh,bckh,bckhp->bcqhp", M, dtc, xh)

    # chunk states + the inter-chunk recurrence
    decay_end = torch.exp(seg[:, :, -1:, :] - seg)          # [B,nc,Q,H]
    states = torch.einsum("bckh,bckn,bckhp->bchpn",
                          dtc * decay_end, Bc, xh)          # [B,nc,H,P,N]
    chunk_decay = torch.exp(seg[:, :, -1])                  # [B,nc,H]
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                   # [B,nc,H,P,N]

    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cc, h_prevs,
                         torch.exp(seg))
    y = (y_diag + y_off).reshape(Bsz, Sp, H, P)[:, :S]
    y = y + params["D"][None, None, :, None] * xs.reshape(
        Bsz, Sp, H, P)[:, :S]
    y = y.reshape(Bsz, S, d_inner)
    y = _gated_norm(y, z, params["norm"], cfg.norm_eps)
    return (row_parallel(y, params["out_proj"], d_inner).to(x.dtype), h,
            conv_state)


def mamba_decode_step(params, x: torch.Tensor, state: torch.Tensor,
                      conv_state: torch.Tensor, cfg):
    """x [B, 1, d]; state [B, H, P, N]; conv_state [B, 3, conv_ch] →
    (y [B, 1, d], state', conv_state').  On a mesh ``state`` is this
    rank's block of heads and ``conv_state`` of channels (a sharded pool)
    or whole (a replicated one), and come back the same way."""
    Bsz = x.shape[0]
    d_inner, H, P = ssm_dims(cfg)
    N = cfg.ssm_state
    conv_ch = d_inner + 2 * N
    n_proj = 2 * d_inner + 2 * N + H
    proj = to_whole(matmul(x, params["in_proj"]), -1, n_proj)
    z, xBC, dt_raw = _split_proj(cfg, proj)
    conv_w = params["conv_w"]
    cs_new = None
    if conv_w.shape[-1] != conv_ch:               # a channel block
        if conv_state.shape[-1] == conv_ch:       # of a whole state
            cs_new = torch.cat([conv_state, xBC],
                               dim=1)[:, -(conv_w.shape[0] - 1):]
        xBC, cs = _conv(to_block(xBC, -1, conv_ch), conv_w,
                        to_block(conv_state, -1, conv_ch))
        xBC = to_whole(xBC, -1, conv_ch)
    else:
        xBC, cs = _conv(xBC, conv_w, conv_state)
    conv_state = cs if cs_new is None else cs_new
    xs, B, C = torch.split(xBC, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])   # [B,H]
    A = -torch.exp(params["A_log"])
    D = params["D"]
    xh = xs[:, 0].reshape(Bsz, H, P).float()
    if state.shape[1] != H:                       # a block of heads
        dt, A, D = (to_block(t, -1, H) for t in (dt, A, D))
        xh = to_block(xh, 1, H)
    Bv = B[:, 0].float()                                    # [B,N]
    Cv = C[:, 0].float()
    decay = torch.exp(dt * A)                               # [B,H]
    state = state * decay[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt, Bv, xh)
    y = torch.einsum("bn,bhpn->bhp", Cv, state) \
        + D[None, :, None] * xh
    y = to_whole(y.reshape(Bsz, 1, -1), -1, d_inner)
    y = _gated_norm(y, z, params["norm"], cfg.norm_eps)
    return (row_parallel(y, params["out_proj"], d_inner).to(x.dtype), state,
            conv_state)
