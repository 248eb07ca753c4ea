"""Shared model layers: norms, RoPE, direct and chunked (flash-style)
attention, the dense MLPs and the sort-based top-k MoE.

Counterpart of ``repro/models/layers.py``.  All attention flows through
:func:`attention`, which dispatches between a direct path (small S) and a
memory-bounded chunked online-softmax path, so activation memory stays
O(S·chunk) instead of O(S²).  The MoE runs the reference's local grouped
path, and on a device mesh its expert-parallel path
(``distributed/moe_ep.py``), both through one dispatch and one combine.
:func:`mlp` takes its local-shard form on a device mesh
(``distributed/axes.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .quantized import promoted, qmm
from .tp import col_input, row_parallel

#: additive mask constant of the dense attention paths; the paged paths
#: (serve/engine.py, kernels/paged_attention) use -1e30 instead
NEG_INF = -2.0 ** 30


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with a ``1 + scale`` gain (zero-initialised
    scales are the identity)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding over ``x [..., S, D]``; ``positions`` broadcasts
    against ``x.shape[:-1]``.  Pairs are the two halves of the vector
    (element i with element i + D/2), not interleaved neighbours."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[..., None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def _mask_bias(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """[Sq, Sk] additive bias: 0 where allowed, ``NEG_INF`` elsewhere."""
    ok = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        ok &= qpos[:, None] - kpos[None, :] < window
    return torch.where(ok, 0.0, NEG_INF)


def direct_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                     kv_valid: Optional[torch.Tensor] = None):
    """q [B,Hkv,G,Sq,D], k/v [B,Hkv,Sk,D] → [B,Hkv,G,Sq,D]."""
    Sq, D = q.shape[3], q.shape[4]
    Sk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.float() * scale, k.float())
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    s = s + _mask_bias(qpos, kpos, causal, window)[None, None, None]
    if kv_valid is not None:
        s = torch.where(kv_valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()).to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      chunk_q=512, chunk_k=1024, p_bf16=False,
                      causal_groups=0,
                      kv_valid: Optional[torch.Tensor] = None):
    """Flash-style two-level loop with an online softmax; O(Sq·chunk_k)
    live memory.  ``causal_groups=N`` splits the q axis into N groups, each
    visiting only its causal KV prefix."""
    if kv_valid is not None:
        raise ValueError("kv_valid is only supported on the direct path")
    B, H, G, Sq, D = q.shape
    Sk = k.shape[2]
    cq, ck = min(chunk_q, Sq), min(chunk_k, Sk)
    pad_q, pad_k = (-Sq) % cq, (-Sk) % ck
    qp = F.pad(q, (0, 0, 0, pad_q))
    kp = F.pad(k, (0, 0, 0, pad_k))
    vp = F.pad(v, (0, 0, 0, pad_k))
    valid = torch.arange(Sk + pad_k, device=q.device) < Sk
    nq, nk = qp.shape[3] // cq, kp.shape[2] // ck
    scale = 1.0 / math.sqrt(D)

    def q_chunk(qi: int, nk_bound: int) -> torch.Tensor:
        qpos = q_offset + qi * cq + torch.arange(cq, device=q.device)
        qc = qp[:, :, :, qi * cq:(qi + 1) * cq].float() * scale
        m = torch.full((B, H, G, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, G, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, G, cq, D), dtype=torch.float32,
                          device=q.device)
        for ki in range(nk_bound):
            kc = kp[:, :, ki * ck:(ki + 1) * ck].float()
            vc = vp[:, :, ki * ck:(ki + 1) * ck]
            kpos = ki * ck + torch.arange(ck, device=q.device)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc)
            s = s + _mask_bias(qpos, kpos, causal, window)[None, None, None]
            s = torch.where(valid[ki * ck:(ki + 1) * ck][None, None, None,
                                                         None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            if p_bf16:
                pv = torch.einsum("bhgqk,bhkd->bhgqd", p.bfloat16(),
                                  vc.bfloat16()).float()
            else:
                pv = torch.einsum("bhgqk,bhkd->bhgqd", p, vc.float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)

    if causal and causal_groups > 1 and not window and q_offset == 0:
        # triangular scheduling: q group g only visits its causal KV prefix
        ngr = min(causal_groups, nq)
        per = -(-nq // ngr)
        outs = []
        for g in range(ngr):
            q_lo, q_hi = g * per, min((g + 1) * per, nq)
            if q_lo >= q_hi:
                break
            nk_bound = min(nk, -(-(q_hi * cq) // ck))
            outs.extend(q_chunk(qi, nk_bound) for qi in range(q_lo, q_hi))
    else:
        outs = [q_chunk(qi, nk) for qi in range(nq)]
    return torch.cat(outs, dim=3)[:, :, :, :Sq]


def attention(q, k, v, *, causal=True, window=0, q_offset=0,
              chunk_q=512, chunk_k=1024, p_bf16=False, causal_groups=0,
              kv_valid=None):
    """Dispatch: q [B,Hq,Sq,D] (Hq = Hkv·G), k/v [B,Hkv,Sk,D]."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, D)
    if Sq * Sk <= 512 * 2048 or Sq == 1:
        out = direct_attention(qg, k, v, causal=causal, window=window,
                               q_offset=q_offset, kv_valid=kv_valid)
    else:
        out = chunked_attention(qg, k, v, causal=causal, window=window,
                                q_offset=q_offset, chunk_q=chunk_q,
                                chunk_k=chunk_k, p_bf16=p_bf16,
                                causal_groups=causal_groups,
                                kv_valid=kv_valid)
    return out.reshape(B, Hq, Sq, D)


# --------------------------------------------------------------------------
# channel mixers
# --------------------------------------------------------------------------
def mlp(params, x: torch.Tensor, act: str, d_ff: int) -> torch.Tensor:
    """MLP with dense or quantized weights (``quantized.qmm``): ``swiglu``
    (w1, w3, w2), ``sq_relu`` (nemotron) or ``gelu`` with the tanh
    approximation (whisper); ``d_ff`` is the whole hidden width.  Under a
    mesh's ``logical_axes`` w1/w3 may be column blocks, so the hidden is
    this rank's block, and the row block of w2 ends in one all-reduce
    (``models/tp.py``; under the train step ``x`` enters the column
    blocks through ``to_model``); elsewhere the plain products."""
    x = col_input(x, params["w1"], d_ff)
    if act == "swiglu":
        h = F.silu(qmm(x, params["w1"])) * qmm(x, params["w3"])
    elif act == "sq_relu":
        h = torch.square(F.relu(qmm(x, params["w1"])))
    elif act == "gelu":
        h = F.gelu(qmm(x, params["w1"]), approximate="tanh")
    else:
        raise ValueError(f"unknown activation {act!r}")
    return row_parallel(h, params["w2"], d_ff)


def _moe_groups(T: int, want: int = 32) -> int:
    g = min(want, T)
    while T % g:
        g -= 1
    return max(g, 1)


def moe(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Top-k capacity MoE on x [B, S, d].  Under a mesh's
    ``logical_axes`` the reference's routing to the expert-parallel path
    (``distributed/moe_ep.py::moe_ep``) when the batch splits over the
    batch axes: the serve decode shape [slots, 1, d] goes in as [1, slots,
    d] when the slots split over an EP ``model`` axis, so each rank routes
    only its slots, and ``moe_legacy_dispatch`` merges B·S first.  Without
    a mesh, or when the batch does not split, the local grouped path.

    ``x`` is this rank's block over the batch axes when the batch split:
    the train step and the serve engine each say whether they cut theirs
    (``axes.batch_cut``).  A batch left whole takes the local path with
    the experts gathered whole over ``model`` (:func:`_whole_experts`)."""
    from ..distributed.axes import _AXES, batch_cut
    from ..distributed.sharding import batch_axes_for
    ctx = _AXES.get()
    B, S, d = x.shape
    if ctx is not None:
        mesh = ctx["mesh"]
        n_b = mesh.axis_size(batch_axes_for(mesh))
        if batch_cut():
            from ..distributed.moe_ep import moe_ep
            n_m = mesh.shape["model"]
            ep = cfg.n_experts % n_m == 0 and n_m > 1
            if cfg.moe_legacy_dispatch:
                # the reference's old path: B·S merged before the dispatch
                # (this rank's rows of the reference's global reshape)
                s_div = n_m if (ep and S % n_m == 0) else 1
                xm = x.reshape(s_div, (B * S) // s_div, d)
                return moe_ep(params, xm, cfg, mesh).reshape(B, S, d)
            if S == 1 and B > 1 and n_b == 1 and ep and B % n_m == 0:
                return moe_ep(params, x.reshape(1, B, d), cfg, mesh
                              ).reshape(B, S, d)
            return moe_ep(params, x, cfg, mesh)
        params = _whole_experts(params, cfg, mesh)
    return _moe_local(params, x.reshape(B * S, d), cfg).reshape(B, S, d)


def _whole_experts(params, cfg, mesh):
    """The experts' weights whole over ``model`` on ``mesh``
    (``gather_model``: under the train step its backward keeps this
    rank's block, every ``model`` rank running the same local path; in
    serving it records nothing); ``params`` itself on a 1-wide axis."""
    from ..launch.mesh import gather_model
    if mesh.shape["model"] == 1:
        return params
    out = dict(params)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff or cfg.d_ff
    whole = {"w1": (E, d, f), "w3": (E, d, f), "w2": (E, f, d)}
    for k, shape in whole.items():
        for dim, n in enumerate(shape):
            if out[k].shape[dim] != n:
                out[k] = gather_model(out[k], mesh, dim)
    return out


def moe_dispatch(xg: torch.Tensor, router: torch.Tensor, K: int, E: int,
                 cap: int):
    """Route xg [G, Tg, d] top-``K`` of ``E`` experts within each group
    and dispatch it into a [G, E, cap, d] buffer: ``(buf, route)``, where
    ``route`` is what :func:`moe_combine` needs.  The (token, choice)
    pairs are sorted by expert stably, so the pairs past an expert's
    capacity ``cap`` are the ones the reference drops; a dropped pair adds
    zeros into its expert's last row (exact in any order, so the scatter
    needs no fixed order).  Shared by the local path (G groups) and
    ``moe_ep`` (one group)."""
    G, Tg, d = xg.shape
    dev = xg.device
    logits = torch.einsum("gtd,de->gte", xg.float(), router.float())
    probs = torch.softmax(logits, -1)
    topw, topi = torch.topk(probs, K, dim=-1, sorted=True)   # [G, Tg, K]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    eflat = topi.reshape(G, Tg * K)
    order = torch.argsort(eflat, dim=1, stable=True)         # per group
    e_sorted = torch.gather(eflat, 1, order)
    seg_start = torch.searchsorted(
        e_sorted, torch.arange(E, device=dev).expand(G, E).contiguous())
    pos_in_e = (torch.arange(Tg * K, device=dev)[None]
                - torch.gather(seg_start, 1, e_sorted))
    keep = pos_in_e < cap
    tok = torch.div(order, K, rounding_mode="floor")          # [G, Tg*K]
    slot = torch.where(keep, pos_in_e, cap - 1)
    gidx = torch.arange(G, device=dev)[:, None]
    vals = torch.where(keep[..., None],
                       torch.gather(xg, 1, tok[..., None].expand(-1, -1, d)),
                       0.0).to(xg.dtype)
    flat = ((gidx * E + e_sorted) * cap + slot).reshape(-1)
    buf = torch.zeros((G * E * cap, d), dtype=xg.dtype, device=dev)
    buf.index_add_(0, flat, vals.reshape(-1, d))
    w = (torch.gather(topw.reshape(G, Tg * K), 1, order)
         * keep).to(xg.dtype)
    return buf.reshape(G, E, cap, d), (e_sorted, slot, order, w)


def moe_combine(out_e: torch.Tensor, route, K: int) -> torch.Tensor:
    """The experts' outputs out_e [G, E, cap, d] back to tokens [G, Tg,
    d]: each token's K weighted outputs summed in a fixed order (choice 0
    first) in the activations' dtype, so two runs give the same bits on
    any device.  The reference scatter-adds into zeros of that dtype,
    which casts its updates to it; the port does not scatter-add."""
    e_sorted, slot, order, w = route
    G, d = out_e.shape[0], out_e.shape[-1]
    gidx = torch.arange(G, device=out_e.device)[:, None]
    gathered = out_e[gidx, e_sorted, slot]                    # [G, Tg*K, d]
    weighted = (gathered * w[..., None]).to(w.dtype)
    # back to (token, choice) order, then the fixed-order sum over choices
    contrib = torch.empty_like(weighted).scatter_(
        1, order[..., None].expand(-1, -1, d), weighted)
    contrib = contrib.reshape(G, -1, K, d)
    y = contrib[:, :, 0]
    for k in range(1, K):
        y = y + contrib[:, :, k]
    return y


def expert_ffn(buf: torch.Tensor, w1, w3, w2) -> torch.Tensor:
    """The experts' SwiGLU FFNs on buf [G, E, c, d] with weights [E, d,
    f] / [E, f, d], batched einsums in the promoted dtype of activations
    and weights."""
    h = F.silu(torch.einsum("gecd,edf->gecf", *promoted(buf, w1))) \
        * torch.einsum("gecd,edf->gecf", *promoted(buf, w3))
    return torch.einsum("gecf,efd->gecd", *promoted(h, w2))


def _moe_local(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Grouped sort-based top-k MoE with per-group capacity.

    x: [T, d] → [T, d].  Tokens are split into G groups, each routed and
    dispatched on its own (:func:`moe_dispatch`) into a [G, E, cap, d]
    buffer; capacity and groups are host ints from shapes."""
    T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    G = _moe_groups(T, cfg.moe_groups)
    Tg = T // G
    cap = int(max(1, round(Tg * K / E * cfg.capacity_factor)))
    buf, route = moe_dispatch(x.reshape(G, Tg, d), params["router"], K, E,
                              cap)
    out_e = expert_ffn(buf, params["w1"], params["w3"], params["w2"])
    return moe_combine(out_e, route, K).reshape(T, d)
