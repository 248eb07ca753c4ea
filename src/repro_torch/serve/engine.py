"""Device-resident continuous-batching decode engine (counterpart of
``repro/serve/engine.py``).

The MTL's mechanism — page pool, page table, seq_lens, free stack — lives
on the device as a :class:`PagedServeState`; delayed page allocation is
resolved inside the token step with one cumsum over the free stack, and
attention translates pages through the page table on the device.  The
token step is plain eager PyTorch over the layer stack, updating the
state's tensors in place where the reference donates them to a jitted
step.

Every fast-path entry point is asynchronous: ``decode``, ``decode_many``
and ``prefill_chunk`` enqueue device work and return device tensors
without reading anything back, so the host reads the ``[K, S]`` token
block of a decode horizon once, after dispatch.  In particular
``max_pages`` reaches the attention kernel as the Python int
``self.max_pages``, never as a value read from ``seq_lens``.

Heterogeneous layer stacks: the engine partitions the stack into
property-typed groups and gives each its own cache state —

  * **full** attention layers keep the unbounded paged pool + page table;
  * **ring** layers (sliding-window 'local'/SWA) have bounded liveness:
    only the last ``window`` tokens are ever read, so each slot gets a
    static ring of ``window / page_size`` pages, translation ``pos mod
    window`` through a ring table that never changes;
  * **recurrent** layers (RG-LRU / Mamba-2) have constant size: a fixed
    per-slot state, updated in place on the slots that run.

So gemma3's 5-local:1-global pattern, mixtral's all-SWA MoE stack,
recurrentgemma's R,R,A hybrid and mamba2's attention-free stack serve
through the same token step as a uniform stack.

``attn_impl="kernel"`` (the default) sends attention through
``kernels/paged_attention``: the hand-written Hopper kernel for CUDA
tensors, its plain twin for CPU tensors.  ``attn_impl="gather"`` is the
plain batched twin (:func:`batched_paged_attention`); a CUDA engine
refuses it, because on the card the main path goes through the kernel.
Both take (page row, valid length), so the ring pool rides the same two
paths with its static rows and ``min(seq_len, window)``.

``PagedEngine(mesh=, kv_layout=)`` serves on a ``data x model`` device
mesh (``launch/mesh.py``; DESIGN.md §13) as an SPMD program: one process
per device, each running this engine and the scheduler over its shard.
Params are cut by ``distributed/sharding.py::param_specs`` and the pools
by ``serve_state_specs`` (``kv_layout="shard"``; ``"replicate"`` keeps
them whole on every rank); the page table, allocator and scheduler stay
host-global, the same on every rank.  The token step is then
tensor-parallel, every collective explicit and counted on the mesh:

  * column blocks (``wq``/``wk``/``wv``, ``w1``/``w3``, ``in_*``,
    ``w_a``/``w_i``) give ``model`` blocks of activations, and a row block
    (``wo``, ``w2``, ``out``, ``out_proj``) ends in one all-reduce;
  * the embedding is vocab-sharded: a masked local lookup and one
    all-reduce; the logits are all-gathered over the vocab, so every rank
    samples from the same bits and takes the same host branch;
  * attention follows the pool: a pool cut by kv head attends locally on
    the rank's heads (its q heads are their GQA groups); a pool cut by
    ``head_dim`` takes q/k/v whole, writes its slice, all-reduces the
    partial q·k scores and all-gathers p·v's slices
    (:func:`batched_paged_attention`); a replicated pool is written whole
    and attended whole on every rank;
  * RG-LRU and Mamba-2 take their local-shard forms
    (``models/rglru.py``, ``models/ssm.py``);
  * MoE layers dispatch expert-parallel (``distributed/moe_ep.py``: two
    all-to-alls per layer, or one all-reduce when the experts do not
    divide over ``model``), with ``capacity_factor`` raised to E/K on any
    mesh, as in the reference, so that no token is capacity-dropped.

On a ``data`` axis wider than 1 the token step is also data-parallel
over the slots, with the reference's semantics (its ``constrain(...,
"batch", ...)`` sites):

  * the weights' FSDP dim is cut over ``data`` as well (``param_specs``),
    so a rank holds its ``data x model`` block of each such leaf, and each
    layer gathers its FSDP blocks whole over ``data`` first
    (``models/tp.py::fsdp_layer``);
  * the pools are cut over ``model`` only, so every ``data`` rank holds
    them whole over ``data``, and the page table and allocator stay
    host-global: positions are reserved on every slot;
  * each rank embeds and runs the layers on its block of the slots
    (``distributed/axes.py::constrain``); each layer's new K|V rows, or
    its new recurrent rows, are gathered whole over ``data`` in one
    all-gather before the write into the pools, so every ``data`` rank's
    pools hold every slot; attention reads them for the block's rows;
  * the final hidden rows are gathered whole over ``data`` before the
    logits, so every rank's host scheduler picks the same tokens.

When ``data`` does not divide the slots every rank runs them all (the
reference's fallback rule), and an MoE layer takes the local path with
the experts gathered whole over ``model``.

``kv_layout="auto"`` is ``shard`` on a 1-wide ``model`` axis, where the
two layouts are the same; on a wider one the engine traces one token
step under each on meta (:func:`pick_layout`, the step cost walker of
``distributed/hlo_cost.py`` on a counting mesh of the mesh's shape) and
keeps ``shard`` unless ``replicate`` counts fewer collective bytes, the
reference's rule; ``layout_report`` says what it counted.

Int8 (``q8``) weights serve on any mesh: a ``model`` row block (``wo``,
``w2``) quantizes its activation block with the whole contraction's row
scale and sums the int32 products over ``model``
(``models/quantized.py::qmm_row_block``), so the meshed step's products
are the one-device ones.

A ``1 x 1`` mesh makes no collective; it runs the same ops as
``mesh=None`` except that an MoE layer dispatches its tokens in one group
where the local path takes many.  Refused: the kernel on any mesh of
more than one device (as in the reference).
"""
from __future__ import annotations

import dataclasses
import math
from contextlib import nullcontext
from functools import partial
from typing import Dict, Optional, Tuple, Union

import torch

from ..core.vbi.address_space import VBProps
from ..core.vbi.blocks import VBIAllocator
from ..core.vbi.kvcache import (PagedServeState, aux_swap_charge,
                                fused_decode_scan, init_serve_state,
                                make_ring_table, reserve_positions,
                                write_token_kv)
from ..core.vbi.mtl import MTL
from ..device import resolve_device
from ..distributed import hlo_cost
from ..distributed.axes import (batch_whole, constrain, data_axis,
                                logical_axes, model_sum, to_block, to_whole)
from ..distributed.sharding import (ParamBlocks, Sharding, batch_axes_for,
                                    shard_params, shard_serve_state)
from ..kernels.paged_attention import paged_attention
from ..models.config import LayerSpec, ModelConfig
from ..models.layers import mlp, moe, rms_norm
from ..models.model import _layer_params, _logits
from ..models.rglru import rglru_decode_step
from ..models.ssm import mamba_decode_step, ssm_dims
from ..models.tp import fsdp_layer, row_parallel, vocab_embed
from ..tree import tree_map
from .paged import _qkv_ragged
from .telemetry import StatsView


# --------------------------------------------------------------------------
# the property-typed stack geometry (static; drives pool shapes + the step)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StagePlan:
    """One config stage, serving view: per period entry its kind, spec and
    the [count] global within-kind layer indices the step consumes."""
    count: int
    kinds: Tuple[str, ...]
    specs: Tuple[LayerSpec, ...]
    entry_indices: Tuple[Tuple[int, ...], ...]


@dataclasses.dataclass(frozen=True)
class StackGeom:
    """The layer stack partitioned by data property: 'full' = unbounded
    paged KV, 'ring' = bounded liveness (window), 'rglru'/'mamba' =
    constant-size recurrent state."""
    kinds: Tuple[str, ...]
    n_full: int
    n_ring: int
    n_rg: int
    n_ssm: int
    window: int                      # shared ring window (0 = no ring)
    ring_pages: int
    stage_plans: Tuple[StagePlan, ...]

    @property
    def has_full(self) -> bool:
        return self.n_full > 0

    @property
    def n_recurrent(self) -> int:
        return self.n_rg + self.n_ssm

    @property
    def uniform_paged(self) -> bool:
        """True iff every layer is full attention."""
        return self.n_ring == 0 and self.n_recurrent == 0

    @property
    def kind_props(self) -> VBProps:
        props = VBProps.NONE
        if self.n_ring:
            props |= VBProps.RING
        if self.n_recurrent:
            props |= VBProps.RECURRENT
        return props


def _entry_kind(spec: LayerSpec) -> str:
    # cfg.stages() stamps the effective window onto every spec (uniform
    # SWA included), so spec.window alone decides: a cfg.window fallback
    # would misclassify the global layers of a local/global stack
    if spec.kind in ("attn", "local"):
        return "ring" if spec.window else "full"
    return spec.kind                                 # 'rglru' | 'mamba'


def build_stack_geom(cfg: ModelConfig, page_size: int) -> StackGeom:
    """Classify ``cfg``'s layer stack into property-typed groups and lay
    out per-stage plans.  Raises ``ValueError`` for shapes the engine
    cannot express (encoder-decoder; ring windows that differ or that
    ``page_size`` does not divide)."""
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name}: encoder-decoder models are not "
                         f"servable through PagedEngine")
    counts = {"full": 0, "ring": 0, "rglru": 0, "mamba": 0}
    windows = set()
    plans = []
    for st in cfg.stages():
        kinds = tuple(_entry_kind(sp) for sp in st.period)
        per_kind = {k: kinds.count(k) for k in set(kinds)}
        rank = {k: 0 for k in per_kind}
        idx = []
        for sp, k in zip(st.period, kinds):
            idx.append(tuple(counts[k] + per_kind[k] * j + rank[k]
                             for j in range(st.count)))
            rank[k] += 1
            if k == "ring":
                windows.add(sp.window)
        for k, n in per_kind.items():
            counts[k] += n * st.count
        plans.append(StagePlan(st.count, kinds, tuple(st.period),
                               tuple(idx)))
    window = 0
    if windows:
        if len(windows) != 1:
            raise ValueError(f"{cfg.name}: ring layers must share one "
                             f"window, got {sorted(windows)}")
        window = windows.pop()
        if window % page_size:
            raise ValueError(
                f"{cfg.name}: sliding window {window} must be a multiple "
                f"of page_size {page_size} so ring translation stays "
                f"page-exact — pick a page_size dividing the window")
    return StackGeom(
        kinds=tuple(k for p in plans for _ in range(p.count)
                    for k in p.kinds),
        n_full=counts["full"], n_ring=counts["ring"], n_rg=counts["rglru"],
        n_ssm=counts["mamba"], window=window,
        ring_pages=window // page_size if window else 0,
        stage_plans=tuple(plans))


# --------------------------------------------------------------------------
# batched paged attention over the device page pool
# --------------------------------------------------------------------------
def batched_paged_attention(q: torch.Tensor, k_pages_l: torch.Tensor,
                            v_pages_l: torch.Tensor, page_table: torch.Tensor,
                            seq_lens: torch.Tensor,
                            max_pages: int) -> torch.Tensor:
    """The plain twin of the paged-attention kernel: all slots at once,
    translation via the device page table.

    q [S, n_kv, g, hd] (pre-scaled f32); k/v_pages_l [n_pages, ps, n_kv,
    hd]; page_table [S, max_pages_per_seq]; seq_lens [S] → [S, n_kv, g,
    hd].  The ring pool uses the same contract with its static page rows
    and ``seq_lens`` clipped to the window.  On a mesh a pool may hold
    this rank's ``model`` block of ``hd`` (q is whole): each rank then
    scores its slice, one all-reduce sums the partial q·k scores (the
    softmax is the same on every rank) and p·v's slices are gathered
    whole."""
    hd = q.shape[-1]
    hd_cut = k_pages_l.shape[-1] != hd
    qs = to_block(q, -1, hd) if hd_cut else q
    pts = page_table[:, :max_pages].long()                # [S, P]
    S, P = pts.shape
    ps = k_pages_l.shape[1]
    k = k_pages_l[pts].reshape(S, P * ps, *k_pages_l.shape[2:])
    v = v_pages_l[pts].reshape(S, P * ps, *v_pages_l.shape[2:])
    s = torch.einsum("shgd,sphd->shgp", qs, k.to(q.dtype))
    if hd_cut:
        s = model_sum(s)
    mask = (torch.arange(P * ps, device=q.device)[None]
            < seq_lens[:, None])[:, None, None, :]
    s = torch.where(mask, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    out = torch.einsum("shgp,sphd->shgd", p, v.to(q.dtype))
    out = out / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return to_whole(out, -1, hd)


def _kernel_paged_attention(q, k_pages_l, v_pages_l, page_table, seq_lens,
                            max_pages: int) -> torch.Tensor:
    """Same contract through ``kernels/paged_attention``: the Hopper
    kernel on CUDA tensors, the plain one-sequence oracle on CPU ones."""
    return paged_attention(q, k_pages_l, v_pages_l, page_table, seq_lens,
                           max_pages)


# --------------------------------------------------------------------------
# the token step (shared by decode and chunked prefill)
# --------------------------------------------------------------------------
def _rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's block of ``t``'s slot rows over the batch axes (a
    view), or ``t`` itself where they are 1 wide or do not divide."""
    return constrain(t, "batch", *(None,) * (t.dim() - 1))


def _token_step(cfg: ModelConfig, geom: StackGeom, max_pages: int,
                attn_impl: str, ring_table: torch.Tensor, specs, params,
                state: PagedServeState, tokens: torch.Tensor,
                slot_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, PagedServeState]:
    """One token for every masked slot through the heterogeneous stack:
    reserve → per layer by its kind (paged or ring KV scatter + paged
    attention, or a recurrent update on the masked slots; then the MLP or
    MoE) → logits.  Updates ``state`` in place; reads nothing back to the
    host.  Under a mesh's ``logical_axes`` the step is tensor-parallel
    (module doc); the shapes of the pools say how a mesh cut them (dim 3:
    kv heads, dim 4: head_dim).  On a wide ``data`` axis the layers run on
    this rank's slot rows, ``specs`` (the params' ``param_specs``) naming
    the FSDP blocks each layer gathers, and the pools and the logits stay
    whole over ``data`` (module doc)."""
    S = tokens.shape[0]
    state, positions = reserve_positions(state, slot_mask,
                                         has_full=geom.has_full)
    rows = _rows if data_axis() is not None else (lambda t: t)
    pos_b = rows(positions)
    x = vocab_embed(params["embed"], rows(tokens),
                    cfg.vocab).float()[:, None, :]              # [B,1,d]
    attn_fn = (_kernel_paged_attention if attn_impl == "kernel"
               else batched_paged_attention)
    B = x.shape[0]
    if geom.n_full or geom.n_ring:
        g = cfg.n_heads // cfg.n_kv
        scale = 1.0 / math.sqrt(cfg.head_dim)
        n_q = cfg.n_heads * cfg.head_dim
    if geom.n_ring:
        # seq_lens already counts this token: the window is the last
        # ``window`` tokens including it
        ring_pos = positions % geom.window
        ring_lens = torch.clamp(state.seq_lens, max=geom.window)
    for si, (plan, sp) in enumerate(zip(geom.stage_plans, params["stages"])):
        for j in range(plan.count):
            for i, kind in enumerate(plan.kinds):
                lp = fsdp_layer(_layer_params(sp[i], j), None if specs is None
                                else specs["stages"][si][i], cfg)
                li = plan.entry_indices[i][j]
                h = rms_norm(x, lp["ln1"], cfg.norm_eps)
                if kind in ("full", "ring"):
                    if kind == "full":
                        kp, vp, table = (state.k_pages, state.v_pages,
                                         state.page_table)
                        pos, lens, width = positions, state.seq_lens, \
                            max_pages
                    else:
                        # bounded liveness: translation pos mod window
                        # into the slot's static ring row, frames reused
                        kp, vp, table = state.k_ring, state.v_ring, \
                            ring_table
                        pos, lens, width = ring_pos, ring_lens, \
                            geom.ring_pages
                    q, k, v = _qkv_ragged(cfg, lp["attn"], h, pos_b,
                                          heads_local=kp.shape[3] != cfg.n_kv)
                    qg = (q[:, :, 0].float() * scale).reshape(
                        B, k.shape[1], g, cfg.head_dim).contiguous()
                    kt, vt = k[:, :, 0], v[:, :, 0]
                    if kp.shape[-1] != cfg.head_dim:  # a head_dim block
                        kt = to_block(kt, -1, cfg.head_dim)
                        vt = to_block(vt, -1, cfg.head_dim)
                    # every data rank's pool takes every slot's row
                    kt, vt = batch_whole((kt, vt), S)
                    write_token_kv(kp, vp, li, table, pos, slot_mask, kt, vt)
                    o = attn_fn(qg, kp[li], vp[li], rows(table), rows(lens),
                                width)
                    x = x + row_parallel(o.reshape(B, 1, -1).to(x.dtype),
                                         lp["attn"]["wo"], n_q)
                elif kind == "rglru":
                    o, hh, cv = rglru_decode_step(
                        lp["rglru"], h, rows(state.rg_h[li]),
                        rows(state.rg_conv[li]), cfg)
                    hh, cv = batch_whole((hh, cv), S)
                    _update_rows(state.rg_h[li], hh, slot_mask)
                    _update_rows(state.rg_conv[li], cv, slot_mask)
                    x = x + o
                else:                                        # mamba
                    o, st, cv = mamba_decode_step(
                        lp["mamba"], h, rows(state.ssm_state[li]),
                        rows(state.ssm_conv[li]), cfg)
                    st, cv = batch_whole((st, cv), S)
                    _update_rows(state.ssm_state[li], st, slot_mask)
                    _update_rows(state.ssm_conv[li], cv, slot_mask)
                    x = x + o
                if kind != "mamba":                      # channel mixer
                    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
                    x = x + (moe(lp["moe"], h2, cfg) if plan.specs[i].moe
                             else mlp(lp["mlp"], h2, cfg.act, cfg.d_ff))
    x, = batch_whole((x,), S)
    return to_whole(_logits(cfg, params, x), -1, cfg.vocab), state


def _update_rows(dst: torch.Tensor, new: torch.Tensor,
                 slot_mask: torch.Tensor) -> None:
    """``dst[s] = new[s]`` for the masked slots, in place, without a host
    read (a select over all slots, not a boolean-mask index)."""
    mask = slot_mask.reshape((-1,) + (1,) * (dst.dim() - 1))
    dst.copy_(torch.where(mask, new.to(dst.dtype), dst))


def _check_mesh(mesh, dev: torch.device, attn_impl: str) -> None:
    """The mesh refusals: the kernel on a mesh of more than one device
    (the reference's own) and a mesh whose processes hold other devices
    than the engine's."""
    if mesh.size > 1 and attn_impl == "kernel":
        raise ValueError(
            "attn_impl='kernel' is not sharding-aware: the paged-attention "
            "kernel assumes a single-device page pool and slot batch. Use "
            "attn_impl='gather' on a mesh of more than one device (or a "
            "1x1 mesh)")
    if mesh.size > 1 and mesh.device_type != dev.type:
        raise ValueError(f"the mesh's processes hold {mesh.device_type} "
                         f"devices, the engine runs on {dev}")


def pool_geometry(cfg: ModelConfig, geom: StackGeom, n_pages: int,
                  page_size: int, max_seqs: int, max_pages: int) -> Dict:
    """The engine's pools as ``kvcache.init_serve_state``'s arguments."""
    rnn_w = (cfg.rnn_width or cfg.d_model) if geom.n_rg else 0
    ssm_H = ssm_P = ssm_conv_ch = 0
    if geom.n_ssm:
        d_inner, ssm_H, ssm_P = ssm_dims(cfg)
        ssm_conv_ch = d_inner + 2 * cfg.ssm_state
    return dict(
        n_layers=geom.n_full, n_pages=n_pages, page_size=page_size,
        n_kv=cfg.n_kv, head_dim=cfg.head_dim, max_seqs=max_seqs,
        max_pages_per_seq=max_pages, dtype=torch.float32,
        n_ring_layers=geom.n_ring, ring_pages=geom.ring_pages,
        n_rg=geom.n_rg, rnn_width=rnn_w, conv_width=cfg.conv_width,
        n_ssm=geom.n_ssm, ssm_heads=ssm_H, ssm_proj=ssm_P,
        ssm_state_size=cfg.ssm_state, ssm_conv_ch=ssm_conv_ch)


def pick_layout(cfg: ModelConfig, geom: StackGeom, mesh_axes: Dict, params,
                pool: Dict, max_pages: int) -> Tuple[str, Dict]:
    """``kv_layout="auto"`` (the reference's ``_pick_layout``): one decode
    token step of the engine's config traced on meta under ``shard`` and
    under ``replicate`` (:func:`trace_token_step`), each on a counting
    mesh of ``mesh_axes`` at rank 0's coordinates, so every rank makes the
    same choice with no collective; ``shard`` unless ``replicate`` counts
    fewer collective bytes.  Returns (the layout, ``{"chosen",
    "candidates": {layout: {"collective_bytes", "predicted_comms_share",
    "flops"}}}``)."""
    reports = {}
    for layout in ("shard", "replicate"):
        cost, _ = trace_token_step(cfg, geom, mesh_axes, layout, params,
                                   pool, max_pages)
        r = cost.report()
        reports[layout] = {
            "collective_bytes": r["collectives"]["total"],
            "predicted_comms_share": hlo_cost.comms_share(r),
            "flops": r["flops"]}
    chosen = ("shard" if reports["shard"]["collective_bytes"]
              <= reports["replicate"]["collective_bytes"] else "replicate")
    return chosen, {"chosen": chosen, "candidates": reports}


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def trace_token_step(cfg: ModelConfig, geom: StackGeom, mesh_axes: Dict,
                     layout: str, params, pool: Dict, max_pages: int):
    """One token step of every slot traced on meta by the step cost walker
    (``distributed/hlo_cost.py``): rank 0 of a
    ``launch/mesh.py::CountingMesh`` of ``mesh_axes``, its pools cut by
    ``serve_state_specs`` under ``layout``, on the plain batched attention
    (the kernel is refused on a mesh of more than one device).
    ``params`` is a rank's blocks for a mesh of this shape
    (``ParamBlocks``; only shapes and dtypes are read) and ``pool`` the
    engine's pool geometry.  Returns (walker cost, counting mesh);
    nothing of a live mesh or pool is touched."""
    from ..launch.mesh import CountingMesh
    mesh = CountingMesh(dict(mesh_axes))
    blocks = ParamBlocks(tree_map(_meta, dict(params)))
    blocks.mesh, blocks.specs = mesh, getattr(params, "specs", None)
    state, _ = shard_serve_state(mesh, layout, "meta", **pool)
    S = pool["max_seqs"]
    ring = torch.empty((S, max(geom.ring_pages, 1)), dtype=torch.int32,
                       device="meta")
    tokens = torch.empty((S,), dtype=torch.int32, device="meta")
    mask = torch.empty((S,), dtype=torch.bool, device="meta")
    batch_cut = S % mesh.axis_size(batch_axes_for(mesh)) == 0
    with logical_axes(mesh, cfg.n_experts, batch_cut=batch_cut):
        cost = hlo_cost.trace_step(
            _token_step, cfg, geom, max_pages, "gather", ring,
            blocks.specs, blocks, state, tokens, mask, mesh=mesh)
    return cost, mesh


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------
class PagedEngine:
    """Continuous-batching serve engine over property-typed cache blocks:
    any decoder-only stack ``cfg.stages()`` can express (uniform, local/
    global, all-SWA MoE, RG-LRU hybrid, pure SSM).

    The engine is compute only: all page lifecycle goes through
    ``self.alloc`` (:class:`~repro_torch.core.vbi.blocks.VBIAllocator`);
    policy lives in ``serve/scheduler.py``.  ``params`` must already live
    on ``device``; ``host_swap_pages > 0`` gives the allocator a host swap
    tier of that many pages.  ``mesh`` (a ``launch/mesh.py::Mesh``) and
    ``kv_layout`` serve on a device mesh (module doc): on a mesh of more
    than one device, ``params`` is either this rank's blocks
    (``distributed/sharding.py::shard_params`` on this mesh, as the
    launcher gives it) or the whole tree on the host or on ``device``, of
    which only this rank's blocks are copied to ``device``.
    ``self.params`` holds the blocks, ``self.shardings`` each pool leaf's
    :class:`Sharding` and ``self.placement`` one device name per mesh
    device; ``kv_layout="auto"`` (the default) resolves by
    :func:`pick_layout` on a wide ``model`` axis, whose report
    ``self.layout_report`` keeps (None otherwise)."""

    def __init__(self, cfg: ModelConfig, params, n_pages: int = 256,
                 page_size: int = 16, max_seqs: int = 8,
                 max_pages_per_seq: Optional[int] = None,
                 attn_impl: str = "kernel", mtl: Optional[MTL] = None,
                 host_swap_pages: int = 0, eos_id: int = -1,
                 device: Union[str, torch.device] = "cuda",
                 mesh=None, kv_layout: str = "auto"):
        if attn_impl not in ("gather", "kernel"):
            raise ValueError(f"attn_impl must be 'gather' or 'kernel', got "
                             f"{attn_impl!r}")
        if kv_layout not in ("auto", "shard", "replicate"):
            raise ValueError(f"kv_layout must be 'auto', 'shard' or "
                             f"'replicate', got {kv_layout!r}")
        dev = resolve_device(device)
        n_dev = 1 if mesh is None else mesh.size
        if mesh is not None:
            _check_mesh(mesh, dev, attn_impl)
            if cfg.n_experts > 0:
                # no token may be capacity-dropped on a mesh where the
                # unmeshed path keeps it: cap >= T_loc holds iff
                # capacity_factor >= E/K (moe_ep.ep_capacity); at the
                # local path's one-token decode groups the bump leaves cap
                # as it was
                cfg = dataclasses.replace(cfg, capacity_factor=max(
                    cfg.capacity_factor, cfg.n_experts / cfg.top_k))
        if dev.type == "cuda" and attn_impl == "gather" and n_dev == 1:
            raise ValueError(
                "attn_impl='gather' is the plain twin of the paged-attention "
                "kernel; on a CUDA engine attention runs through the kernel "
                "(attn_impl='kernel'), except on a mesh of more than one "
                "device, where the kernel is refused")
        if n_dev > 1:
            if not isinstance(params, ParamBlocks):
                params = shard_params(cfg, params, mesh, dev)
            elif params.mesh is not mesh:
                raise ValueError("params were cut for another mesh")
        if params["embed"].device != dev:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {dev}")
        geom = build_stack_geom(cfg, page_size)
        self.cfg = cfg
        self.geom = geom
        self.device = dev
        self.attn_impl = attn_impl
        self.page_size = page_size
        self.n_pages = n_pages
        self.max_seqs = max_seqs
        self.max_pages = max_pages_per_seq or -(-(n_pages - 1) // max_seqs)
        self.eos_id = eos_id
        # decode_steps counts horizon steps executed, decode_dispatches
        # horizon dispatches, token_steps every token step of either path
        # (a prefill chunk of C columns runs C of them)
        self.stats = {"decode_steps": 0, "decode_dispatches": 0,
                      "prefill_chunks": 0, "token_steps": 0}
        pool = pool_geometry(cfg, geom, n_pages, page_size, max_seqs,
                             self.max_pages)
        # 'auto' traces the token step under both layouts and keeps the
        # one that moves fewer collective bytes (_pick_layout); on a
        # 1-wide 'model' axis the two layouts are the same
        self.layout_report = None
        if mesh is not None and kv_layout == "auto":
            kv_layout = ("shard" if mesh.shape["model"] == 1
                         else self._pick_layout(mesh, params, pool))
        # on a mesh the pools are cut by serve_state_specs (each rank
        # allocates only its blocks); translation stays replicated
        self.mesh = mesh
        self.kv_layout = kv_layout if mesh is not None else None
        self.params = params
        self.shardings: Optional[Dict[str, Sharding]] = None
        if mesh is None:
            self.state = init_serve_state(**pool, device=dev)
        else:
            self.state, self.shardings = shard_serve_state(
                mesh, kv_layout, dev, **pool)
        # a slot's ring frames are static (kvcache.py::make_ring_table):
        # translation is arithmetic; page 0 stays null for masked lanes.
        # Contiguous int32 on the device, once (the kernel reads its rows)
        self.ring_table = torch.from_numpy(
            make_ring_table(max_seqs, geom.ring_pages)).to(dev).contiguous()
        # placement is a data property of every block carved from this
        # pool: the devices its pages live on, one name per mesh device
        # (the same tuple on every rank)
        self.placement = ((f"{dev.type}:{dev.index or 0}",) if mesh is None
                          else tuple(f"{dev.type}:{r}"
                                     for r in range(mesh.size)))
        # the step cuts its slot rows over the batch axes where they
        # divide them (the MoE's route reads which)
        self._axes = (nullcontext if mesh is None else partial(
            logical_axes, mesh, cfg.n_experts,
            batch_cut=max_seqs % mesh.axis_size(batch_axes_for(mesh)) == 0))
        # the engine satisfies the allocator's pool protocol (.state + geom)
        self.alloc = VBIAllocator(self, host_swap_pages=host_swap_pages,
                                  mtl=mtl)
        self._step = partial(_token_step, cfg, geom, self.max_pages,
                             attn_impl, self.ring_table,
                             getattr(params, "specs", None))

    def _pick_layout(self, mesh, params, pool: Dict) -> str:
        """``kv_layout="auto"`` on a wide ``model`` axis
        (:func:`pick_layout`); sets ``layout_report``."""
        chosen, self.layout_report = pick_layout(
            self.cfg, self.geom, mesh.shape, params, pool, self.max_pages)
        return chosen

    def attach_metrics(self, metrics) -> None:
        """Move the engine's dispatch counters onto a shared
        :class:`~repro_torch.serve.telemetry.MetricsRegistry` (keys
        ``engine.*``).  The ``stats`` face stays dict-compatible and keeps
        its counts, so attaching mid-run loses nothing."""
        old = dict(self.stats)
        self.metrics = metrics
        self.stats = StatsView(metrics, prefix="engine.", keys=list(old))
        for k, v in old.items():
            self.stats[k] = v

    # -- the property-typed pool protocol (read by allocator + scheduler) ---
    @property
    def has_full(self) -> bool:
        return self.geom.has_full

    @property
    def supports_prefix_sharing(self) -> bool:
        return self.geom.uniform_paged

    @property
    def kind_props(self) -> VBProps:
        return self.geom.kind_props

    @property
    def aux_swap_pages(self) -> int:
        """Host-tier charge (in pages) of one slot's RING + RECURRENT state
        (``kvcache.py::aux_swap_charge``)."""
        return aux_swap_charge(self.geom.n_ring, self.geom.ring_pages,
                               self.geom.n_recurrent)

    def ring_row(self, slot: int) -> torch.Tensor:
        """``slot``'s static ring frames: a view of a row of
        ``self.ring_table`` on the device (what the swap tier's gather and
        scatter of ring frames translate through)."""
        return self.ring_table[slot]

    # -- the fast paths ------------------------------------------------------
    def decode(self, tokens: torch.Tensor,
               slot_mask: torch.Tensor) -> torch.Tensor:
        """tokens [max_seqs] int32, slot_mask [max_seqs] bool → logits
        [max_seqs, 1, vocab] on the device.  Nothing is read back."""
        # the step writes the pool, page table and free stack of
        # self.state in place, where the reference donates the state to
        # its jitted step and gets a new one back
        with self._axes():
            logits, self.state = self._step(self.params, self.state, tokens,
                                            slot_mask)
        self.stats["decode_steps"] += 1
        self.stats["decode_dispatches"] += 1
        self.stats["token_steps"] += 1
        return logits

    def decode_many(self, tokens: torch.Tensor, slot_mask: torch.Tensor,
                    steps_left: torch.Tensor, k: int) -> torch.Tensor:
        """The fused decode horizon: K token steps — greedy sampling, token
        feedback, per-slot stop masking and delayed page allocation — with
        no host read.  tokens [max_seqs] int32, slot_mask [max_seqs] bool,
        steps_left [max_seqs] int32 → token block [k, max_seqs] int32 on the
        device (-1 on masked lanes).  The page budget for the worst-case
        span must be reserved through ``self.alloc`` before the call."""
        # K steps update self.state in place (the reference donates it)
        with self._axes():
            block, self.state = fused_decode_scan(
                partial(self._step, self.params), self.state, tokens,
                slot_mask, steps_left, length=k, eos_id=self.eos_id)
        self.stats["decode_steps"] += k
        self.stats["decode_dispatches"] += 1
        self.stats["token_steps"] += k
        return block

    @staticmethod
    def ready_event(x: torch.Tensor) -> Optional[torch.cuda.Event]:
        """An event recorded behind everything enqueued so far on the
        current stream — so right behind ``x``'s producer when called as
        ``x`` is dispatched; None for a CPU tensor."""
        if x.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(x.device))
        return ev

    @staticmethod
    def block_ready(x: torch.Tensor,
                    event: Optional[torch.cuda.Event]) -> bool:
        """Non-blocking probe: has the device finished computing ``x``?
        ``event`` is the one :meth:`ready_event` recorded at ``x``'s
        dispatch (None for a CPU tensor): an event recorded later would
        also wait on work enqueued after ``x``."""
        return x.device.type != "cuda" or event.query()

    def prefill_chunk(self, tokens: torch.Tensor,
                      n_tokens: torch.Tensor) -> torch.Tensor:
        """tokens [max_seqs, C] int32, n_tokens [max_seqs] int32 → next
        greedy token per slot, [max_seqs] int32 on the device (argmax of
        each slot's last fed position; the caller reads it only when a slot
        finished its prompt this chunk)."""
        C = tokens.shape[1]
        picks = []      # each column's step updates self.state in place
        with self._axes():
            for c in range(C):
                mask = (c < n_tokens) & self.state.slot_active
                logits, self.state = self._step(self.params, self.state,
                                                tokens[:, c], mask)
                picks.append(torch.argmax(logits[:, 0], -1).to(torch.int32))
        last = torch.clamp(n_tokens - 1, min=0).long()
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        self.stats["prefill_chunks"] += 1
        self.stats["token_steps"] += C
        return torch.stack(picks)[last, rows]

    # -- introspection (reads the device; never call on the fast path) ------
    @property
    def free_pages(self) -> int:
        return int(self.state.free_top)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - 1 - self.free_pages
