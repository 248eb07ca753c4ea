"""Expert-parallel MoE on a device mesh (counterpart of
``repro/distributed/moe_ep.py``).

The reference runs the MoE block under ``shard_map`` with an explicit
all-to-all dispatch.  The port's mesh is an SPMD program with one process
per device (``launch/mesh.py``), where the step's activations are whole
on every rank, so :func:`moe_ep` does by hand what the reference's
``in_specs``/``out_specs`` do:

  * EP, when ``E % n_model == 0`` and ``n_model > 1``: this rank takes its
    token slice over ``model`` (``split_model``) when ``S`` divides,
    routes it locally, sends each expert's buffer to the rank that holds
    the expert (``all_to_all``), runs its ``E / n_model`` experts' FFNs
    on every rank's rows, sends the outputs back (a second all-to-all),
    combines, and all-gathers the token slices (``gather_model``), so
    every rank holds the same bits;
  * TP fallback, when ``E`` does not divide over ``model``: the experts
    are replicated, ``d_ff`` is cut over ``model`` and the partial outputs
    are summed by one all-reduce (``from_model``);
  * ``n_model == 1``: the local dispatch in one group, no collective.

The collectives are ``launch/mesh.py``'s autograd forms, which serving
and the train step share: forward they are the serve path's exchanges;
backward the all-to-all is the reverse exchange, and the router of a
token slice and the TP fallback's buffer enter through ``to_model``
(each rank's gradient is its share).  One route differs in training
(``axes.train_mesh``): EP over tokens that do not split over ``model``
routes every token on every rank, so each rank runs its experts on its
block of the buffer (``split_model``) and the outputs are gathered whole
(``gather_model``); the exchange would hand each expert ``n_model``
copies of every row, whose gradients would add up.  The expert weights
and the router come whole over ``d``: ``models/tp.py::fsdp_layer``
gathers their FSDP blocks over ``data`` at the start of the layer (what
the reference's ``in_specs`` do) and reduce-scatters their gradients.

Routing, the dispatch and the combine are ``models/layers.py``'s
(``moe_dispatch``, ``moe_combine``), shared with the local grouped path,
which passes G groups where this module passes one.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..launch.mesh import (all_to_all, from_model, gather_model,
                           split_model, to_model)
from ..models.layers import expert_ffn, moe_combine, moe_dispatch
from .axes import logical_axes, to_block, train_mesh
from .sharding import batch_axes_for


def _local_dispatch(x_loc: torch.Tensor, router: torch.Tensor, K: int,
                    E: int, cap: int):
    """Local capacity dispatch of x_loc [T, d] in one group: (buf [E, cap,
    d], the route :func:`_local_combine` needs)."""
    buf, route = moe_dispatch(x_loc[None], router, K, E, cap)
    return buf[0], route


def _local_combine(out_e: torch.Tensor, route, K: int) -> torch.Tensor:
    """out_e [E, cap, d] back to the tokens [T, d] of one group."""
    return moe_combine(out_e[None], route, K)[0]


def _ep_layout(cfg, mesh, S: int) -> Tuple[int, int, bool, bool]:
    """(batch shards over the batch axes, model width, EP, tokens split
    over ``model``)."""
    n_b = mesh.axis_size(batch_axes_for(mesh))
    n_m = mesh.shape["model"]
    ep = cfg.n_experts % n_m == 0 and n_m > 1
    return n_b, n_m, ep, ep and S % n_m == 0


def ep_capacity(cfg, mesh, B: int, S: int) -> Tuple[int, int]:
    """(cap, T_loc) that :func:`moe_ep` uses for a [B, S, d] input (``B``
    the whole batch).

    Serving requires cap >= T_loc (no token may be capacity-dropped, or
    decode would diverge from the unmeshed path); the engine raises
    ``capacity_factor`` to E/K on a mesh to guarantee it.  Training keeps
    the config's own, as the reference does."""
    n_b, n_m, _, tok_over_model = _ep_layout(cfg, mesh, S)
    T_loc = (B // n_b) * (S // (n_m if tok_over_model else 1))
    cap = int(max(1, round(T_loc * cfg.top_k / cfg.n_experts
                           * cfg.capacity_factor)))
    return cap, T_loc


def moe_ep(params, x: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """x [B, S, d] → [B, S, d], dispatched expert-parallel on ``mesh``.

    ``x`` is this rank's block over the batch axes (the whole batch on
    1-wide ones), whole over ``model``; the result is too.  The expert
    weights are this rank's blocks over ``model`` as ``param_specs`` cuts
    them (``[E / n, d, f]`` under EP, ``[E, d, f / n]`` and ``[E, f / n,
    d]`` under the TP fallback) or whole, and then this rank takes its
    blocks (views); their ``d`` is whole (module doc)."""
    E, K = cfg.n_experts, cfg.top_k
    B, S, d = x.shape
    n_b, n_m, ep, tok_over_model = _ep_layout(cfg, mesh, S)
    cap, _ = ep_capacity(cfg, mesh, B * n_b, S)
    f = cfg.expert_d_ff or cfg.d_ff
    w1, w3, w2 = params["w1"], params["w3"], params["w2"]
    if not ep and n_m > 1 and f % n_m:
        raise ValueError(f"the TP fallback cuts d_ff {f} over 'model' "
                         f"{n_m}, which does not divide it")
    with logical_axes(mesh, E):
        x_loc, router = x, params["router"]
        if tok_over_model:
            x_loc, router = split_model(x, mesh, 1), to_model(router, mesh)
        x2 = x_loc.reshape(-1, d)                           # [T_loc, d]
        buf, route = _local_dispatch(x2, router, K, E, cap)
        if ep:
            e_loc = E // n_m
            w1, w3 = to_block(w1, 0, E), to_block(w3, 0, E)
            w2 = to_block(w2, 0, E)
            if train_mesh() is not None and not tok_over_model:
                o = expert_ffn(split_model(buf, mesh, 0)[None], w1, w3, w2)
                out_e = gather_model(o[0], mesh, 0)
            else:
                # chunk j of the buffer (experts j*e_loc ...) to rank j;
                # back come every rank's rows of this rank's experts, by
                # source
                b = all_to_all(buf.reshape(n_m, e_loc, cap, d), mesh)
                b = b.transpose(0, 1).reshape(1, e_loc, n_m * cap, d)
                o = expert_ffn(b, w1, w3, w2).reshape(e_loc, n_m, cap, d)
                o = all_to_all(o.transpose(0, 1).contiguous(), mesh)
                out_e = o.reshape(E, cap, d)
        else:
            w1, w3 = to_block(w1, 2, f), to_block(w3, 2, f)
            w2 = to_block(w2, 1, f)
            out_e = from_model(expert_ffn(to_model(buf, mesh)[None], w1, w3,
                                          w2)[0], mesh)
        y = _local_combine(out_e, route, K).reshape(x_loc.shape)
        return gather_model(y, mesh, 1) if tok_over_model else y
