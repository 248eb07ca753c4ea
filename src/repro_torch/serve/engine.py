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
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional, Tuple, Union

import torch

from ..core.vbi.address_space import VBProps
from ..core.vbi.blocks import VBIAllocator
from ..core.vbi.kvcache import (PagedServeState, aux_swap_charge,
                                fused_decode_scan, init_serve_state,
                                make_ring_table, reserve_positions,
                                write_token_kv)
from ..core.vbi.mtl import MTL
from ..device import resolve_device
from ..kernels.paged_attention import paged_attention
from ..models.config import LayerSpec, ModelConfig
from ..models.layers import mlp, moe, rms_norm
from ..models.model import _layer_params, _logits
from ..models.rglru import rglru_decode_step
from ..models.ssm import mamba_decode_step, ssm_dims
from .paged import _qkv_ragged


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
    and ``seq_lens`` clipped to the window."""
    pts = page_table[:, :max_pages].long()                # [S, P]
    S, P = pts.shape
    ps = k_pages_l.shape[1]
    k = k_pages_l[pts].reshape(S, P * ps, *k_pages_l.shape[2:])
    v = v_pages_l[pts].reshape(S, P * ps, *v_pages_l.shape[2:])
    s = torch.einsum("shgd,sphd->shgp", q, k.to(q.dtype))
    mask = (torch.arange(P * ps, device=q.device)[None]
            < seq_lens[:, None])[:, None, None, :]
    s = torch.where(mask, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    out = torch.einsum("shgp,sphd->shgd", p, v.to(q.dtype))
    return out / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)


def _kernel_paged_attention(q, k_pages_l, v_pages_l, page_table, seq_lens,
                            max_pages: int) -> torch.Tensor:
    """Same contract through ``kernels/paged_attention``: the Hopper
    kernel on CUDA tensors, the plain one-sequence oracle on CPU ones."""
    return paged_attention(q, k_pages_l, v_pages_l, page_table, seq_lens,
                           max_pages)


# --------------------------------------------------------------------------
# the token step (shared by decode and chunked prefill)
# --------------------------------------------------------------------------
def _token_step(cfg: ModelConfig, geom: StackGeom, max_pages: int,
                attn_impl: str, ring_table: torch.Tensor, params,
                state: PagedServeState, tokens: torch.Tensor,
                slot_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, PagedServeState]:
    """One token for every masked slot through the heterogeneous stack:
    reserve → per layer by its kind (paged or ring KV scatter + paged
    attention, or a recurrent update on the masked slots; then the MLP or
    MoE) → logits.  Updates ``state`` in place; reads nothing back to the
    host."""
    state, positions = reserve_positions(state, slot_mask,
                                         has_full=geom.has_full)
    x = params["embed"][tokens].float()[:, None, :]              # [S,1,d]
    attn_fn = (_kernel_paged_attention if attn_impl == "kernel"
               else batched_paged_attention)
    S = tokens.shape[0]
    if geom.n_full or geom.n_ring:
        g = cfg.n_heads // cfg.n_kv
        scale = 1.0 / math.sqrt(cfg.head_dim)
    if geom.n_ring:
        # seq_lens already counts this token: the window is the last
        # ``window`` tokens including it
        ring_pos = positions % geom.window
        ring_lens = torch.clamp(state.seq_lens, max=geom.window)
    for plan, sp in zip(geom.stage_plans, params["stages"]):
        for j in range(plan.count):
            for i, kind in enumerate(plan.kinds):
                lp = _layer_params(sp[i], j)
                li = plan.entry_indices[i][j]
                h = rms_norm(x, lp["ln1"], cfg.norm_eps)
                if kind in ("full", "ring"):
                    q, k, v = _qkv_ragged(cfg, lp["attn"], h, positions)
                    qg = (q[:, :, 0].float() * scale).reshape(
                        S, cfg.n_kv, g, cfg.head_dim).contiguous()
                    if kind == "full":
                        write_token_kv(state.k_pages, state.v_pages, li,
                                       state.page_table, positions,
                                       slot_mask, k[:, :, 0], v[:, :, 0])
                        o = attn_fn(qg, state.k_pages[li],
                                    state.v_pages[li], state.page_table,
                                    state.seq_lens, max_pages)
                    else:
                        # bounded liveness: translation pos mod window
                        # into the slot's static ring row, frames reused
                        write_token_kv(state.k_ring, state.v_ring, li,
                                       ring_table, ring_pos, slot_mask,
                                       k[:, :, 0], v[:, :, 0])
                        o = attn_fn(qg, state.k_ring[li], state.v_ring[li],
                                    ring_table, ring_lens, geom.ring_pages)
                    x = x + (o.reshape(S, 1, -1).to(x.dtype)
                             @ lp["attn"]["wo"])
                elif kind == "rglru":
                    o, hh, cv = rglru_decode_step(
                        lp["rglru"], h, state.rg_h[li], state.rg_conv[li],
                        cfg)
                    _update_rows(state.rg_h[li], hh, slot_mask)
                    _update_rows(state.rg_conv[li], cv, slot_mask)
                    x = x + o
                else:                                        # mamba
                    o, st, cv = mamba_decode_step(
                        lp["mamba"], h, state.ssm_state[li],
                        state.ssm_conv[li], cfg)
                    _update_rows(state.ssm_state[li], st, slot_mask)
                    _update_rows(state.ssm_conv[li], cv, slot_mask)
                    x = x + o
                if kind != "mamba":                      # channel mixer
                    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
                    x = x + (moe(lp["moe"], h2, cfg) if plan.specs[i].moe
                             else mlp(lp["mlp"], h2, cfg.act))
    return _logits(cfg, params, x), state


def _update_rows(dst: torch.Tensor, new: torch.Tensor,
                 slot_mask: torch.Tensor) -> None:
    """``dst[s] = new[s]`` for the masked slots, in place, without a host
    read (a select over all slots, not a boolean-mask index)."""
    mask = slot_mask.reshape((-1,) + (1,) * (dst.dim() - 1))
    dst.copy_(torch.where(mask, new.to(dst.dtype), dst))


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
    on ``device``."""

    def __init__(self, cfg: ModelConfig, params, n_pages: int = 256,
                 page_size: int = 16, max_seqs: int = 8,
                 max_pages_per_seq: Optional[int] = None,
                 attn_impl: str = "kernel", mtl: Optional[MTL] = None,
                 host_swap_pages: int = 0, eos_id: int = -1,
                 device: Union[str, torch.device] = "cuda"):
        if attn_impl not in ("gather", "kernel"):
            raise ValueError(f"attn_impl must be 'gather' or 'kernel', got "
                             f"{attn_impl!r}")
        dev = resolve_device(device)
        if dev.type == "cuda" and attn_impl == "gather":
            raise ValueError(
                "attn_impl='gather' is the plain twin of the paged-attention "
                "kernel; on a CUDA engine attention runs through the kernel "
                "(attn_impl='kernel')")
        if params["embed"].device != dev:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {dev}")
        geom = build_stack_geom(cfg, page_size)
        self.cfg = cfg
        self.geom = geom
        self.params = params
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
        rnn_w = (cfg.rnn_width or cfg.d_model) if geom.n_rg else 0
        ssm_H = ssm_P = ssm_conv_ch = 0
        if geom.n_ssm:
            d_inner, ssm_H, ssm_P = ssm_dims(cfg)
            ssm_conv_ch = d_inner + 2 * cfg.ssm_state
        self.state = init_serve_state(
            n_layers=geom.n_full, n_pages=n_pages, page_size=page_size,
            n_kv=cfg.n_kv, head_dim=cfg.head_dim, max_seqs=max_seqs,
            max_pages_per_seq=self.max_pages, dtype=torch.float32,
            n_ring_layers=geom.n_ring, ring_pages=geom.ring_pages,
            n_rg=geom.n_rg, rnn_width=rnn_w, conv_width=cfg.conv_width,
            n_ssm=geom.n_ssm, ssm_heads=ssm_H, ssm_proj=ssm_P,
            ssm_state_size=cfg.ssm_state, ssm_conv_ch=ssm_conv_ch,
            device=dev)
        # a slot's ring frames are static (kvcache.py::make_ring_table):
        # translation is arithmetic; page 0 stays null for masked lanes.
        # Contiguous int32 on the device, once (the kernel reads its rows)
        self.ring_table = torch.from_numpy(
            make_ring_table(max_seqs, geom.ring_pages)).to(dev).contiguous()
        # placement is a data property of every block carved from this pool
        self.placement = (f"{dev.type}:{dev.index or 0}",)
        # the engine satisfies the allocator's pool protocol (.state + geom)
        self.alloc = VBIAllocator(self, host_swap_pages=host_swap_pages,
                                  mtl=mtl)
        self._step = partial(_token_step, cfg, geom, self.max_pages,
                             attn_impl, self.ring_table)

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
        return aux_swap_charge(self.geom.n_ring, self.geom.ring_pages,
                               self.geom.n_recurrent)

    # -- the fast paths ------------------------------------------------------
    def decode(self, tokens: torch.Tensor,
               slot_mask: torch.Tensor) -> torch.Tensor:
        """tokens [max_seqs] int32, slot_mask [max_seqs] bool → logits
        [max_seqs, 1, vocab] on the device.  Nothing is read back."""
        # the step writes the pool, page table and free stack of
        # self.state in place, where the reference donates the state to
        # its jitted step and gets a new one back
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
        block, self.state = fused_decode_scan(
            partial(self._step, self.params), self.state, tokens, slot_mask,
            steps_left, length=k, eos_id=self.eos_id)
        self.stats["decode_steps"] += k
        self.stats["decode_dispatches"] += 1
        self.stats["token_steps"] += k
        return block

    @staticmethod
    def block_ready(x: torch.Tensor) -> bool:
        """Non-blocking probe: has the device finished computing ``x``?
        Records an event behind everything enqueued so far on the current
        stream (so after ``x``'s producer) and queries it."""
        if x.device.type != "cuda":
            return True
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(x.device))
        return ev.query()

    def prefill_chunk(self, tokens: torch.Tensor,
                      n_tokens: torch.Tensor) -> torch.Tensor:
        """tokens [max_seqs, C] int32, n_tokens [max_seqs] int32 → next
        greedy token per slot, [max_seqs] int32 on the device (argmax of
        each slot's last fed position; the caller reads it only when a slot
        finished its prompt this chunk)."""
        C = tokens.shape[1]
        picks = []      # each column's step updates self.state in place
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
