"""Sharding rules (counterpart of ``repro/distributed/sharding.py``):
DP/FSDP over ``data`` (+ ``pod``) and TP over ``model`` for params, grads
and optimizer moments; the batch over the batch axes; pools sharded over
``model`` for the paged serve state.

The rules are the reference's, copied: params FSDP-shard their
d_model-like dim over 'data' and their heads/ff/vocab dim over 'model',
by leaf name over the tree path (quantized ``{'q8', 's'}`` leaves follow
their matmul, a scale its output dim), and an axis that does not divide
its dim is dropped.  A spec is a :class:`Spec`: a tuple with, per dim, an
axis name, a tuple of axis names or None (the reference's
``PartitionSpec`` read as a tuple).  A :class:`Sharding` pairs a spec with
a mesh and cuts or gathers a tensor's blocks: in the port's SPMD form a
rank holds only its block of every sharded leaf.

``state_specs`` and ``batch_spec`` are the train half, and
:func:`shard_state` cuts a whole train state into one rank's blocks.
``cache_specs`` cuts the dense decode caches (:class:`CacheBlocks`; the
serve steps of ``serve/step.py``).
``placement_hint`` maps VBI property bits to placement preferences (the
data-aware hook, DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.vbi.address_space import VBProps

if TYPE_CHECKING:
    from ..models.config import ModelConfig


class Spec(tuple):
    """A partition spec: per dim an axis name, a tuple of names or None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def batch_axes_for(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _divisible(n: int, mesh, axis: str) -> bool:
    return n % _axis_size(mesh, axis) == 0


# name → (spec for trailing dims); leading (stack) dims padded with None
_RULES = {
    # attention
    "wq": ("data", "model"), "wk": ("data", "model"), "wv": ("data", "model"),
    "wo": ("model", "data"),
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    # dense mlp
    "w1": ("data", "model"), "w3": ("data", "model"), "w2": ("model", "data"),
    # ssm / rglru
    "in_proj": ("data", "model"), "out_proj": ("model", "data"),
    "in_x": ("data", "model"), "in_gate": ("data", "model"),
    "w_a": ("data", "model"), "w_i": ("data", "model"),
    "out": ("model", "data"),
    "conv_w": (None, "model"),
    # router
    "router": ("data", None),
}

_MOE_LEAVES = {"w1", "w3", "w2"}


def _map_named(fn, tree, names: Tuple[str, ...] = ()):
    """``tree``'s nesting with each leaf replaced by ``fn(names, leaf)``;
    ``names`` are the dict keys on the leaf's path (list and tuple indices
    are not names, as in the reference's ``_leaf_name``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        out = [_map_named(fn, c, names) for c in tree]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(names, tree)


def _leaf_name(names: Tuple[str, ...]) -> str:
    names = list(names)
    # quantized leaves ({'q8','s'}) inherit the enclosing matmul's rule
    while names and names[-1] in ("q8", "s"):
        names.pop()
    return names[-1] if names else ""


def _is_scale(names: Tuple[str, ...]) -> bool:
    return bool(names) and names[-1] == "s"


def _has_moe(names: Tuple[str, ...]) -> bool:
    return "moe" in names


def param_specs(cfg: ModelConfig, params_shape, mesh):
    """Spec tree for a params-shaped tree (grads and optimizer moments
    too): the reference's ``param_specs``."""
    ep = cfg.n_experts > 0 and _divisible(cfg.n_experts, mesh, "model")
    fsdp = fsdp_axes_of(cfg, mesh)

    def _axis_total(ax):
        axes = ax if isinstance(ax, tuple) else (ax,)
        return math.prod(_axis_size(mesh, a) for a in axes)

    def spec_for(names, leaf) -> Spec:
        name = _leaf_name(names)
        nd = len(leaf.shape)
        if _is_scale(names):
            # quantization scale [*, N]: shard like the matmul's output dim
            rule = _RULES.get(name)
            ax = rule[-1] if rule else (
                "model" if name == "lm_head" else None)
            if ax is not None and _divisible(leaf.shape[-1], mesh, ax):
                return Spec(*((None,) * (nd - 1)), ax)
            return Spec(*((None,) * nd))
        if name == "embed":
            # vocab TP only: sharding d would put the contraction dim of
            # the (tied) logits product on 'data' → a full-logits reduce
            return Spec("model", None)
        if name == "lm_head":
            return Spec(None, "model")
        if name in ("step",):
            return Spec()
        if _has_moe(names) and name in _MOE_LEAVES:
            # [*, E, a, b]
            lead = (None,) * (nd - 3)
            if ep:
                if name == "w2":
                    return Spec(*lead, "model", None, fsdp)
                return Spec(*lead, "model", fsdp, None)
            if name == "w2":
                return Spec(*lead, None, "model", fsdp)
            return Spec(*lead, None, fsdp, "model")
        rule = _RULES.get(name)
        if rule is None or nd < len(rule):
            return Spec(*((None,) * nd))
        # verify divisibility; drop axes that do not divide
        dims = leaf.shape[nd - len(rule):]
        fixed = []
        for ax, dim in zip(rule, dims):
            if ax == "data":
                ax = fsdp
            if ax is not None and dim % _axis_total(ax) == 0:
                fixed.append(ax)
            else:
                fixed.append(None)
        return Spec(*((None,) * (nd - len(rule))), *fixed)

    return _map_named(spec_for, params_shape)


def fsdp_axes_of(cfg: ModelConfig, mesh):
    """The axes ``param_specs`` FSDP-cuts a d_model-like dim over:
    ``("pod", "data")`` under ``fsdp_axes == "pod_data"`` on a mesh with
    ``pod``, else ``"data"``."""
    if getattr(cfg, "fsdp_axes", "data") == "pod_data" \
            and "pod" in mesh.axis_names:
        return ("pod", "data")
    return "data"


def state_specs(cfg: ModelConfig, state_shape, mesh):
    """Train-state tree ``{'params', 'opt': {'m', 'v', 'step'}}``: the
    reference's ``state_specs``."""
    return {
        "params": param_specs(cfg, state_shape["params"], mesh),
        "opt": {
            "m": param_specs(cfg, state_shape["opt"]["m"], mesh),
            "v": param_specs(cfg, state_shape["opt"]["v"], mesh),
            "step": Spec(),
        },
    }


def batch_spec(cfg: ModelConfig, batch_shape, mesh):
    """A batch's leaves ``[B, ...]``: dim 0 over the batch axes when their
    product divides ``B`` and exceeds 1, else whole (the reference's
    ``batch_spec``)."""
    baxes = batch_axes_for(mesh)
    n_b = math.prod(_axis_size(mesh, a) for a in baxes)

    def spec_for(names, leaf) -> Spec:
        nd = len(leaf.shape)
        if nd == 0:
            return Spec()
        first = baxes if (leaf.shape[0] % n_b == 0 and n_b > 1) else None
        if isinstance(first, tuple) and len(first) == 1:
            first = first[0]
        return Spec(first, *((None,) * (nd - 1)))

    return _map_named(spec_for, batch_shape)


def cache_specs(cfg: ModelConfig, cache_shape, mesh, batch: int):
    """Decode caches: [count, B, ...].  KV seq shards over 'model' (SP);
    batch over data axes when divisible, else seq additionally over
    'data'."""
    baxes = batch_axes_for(mesh)
    n_b = math.prod(_axis_size(mesh, a) for a in baxes)
    shard_batch = batch % n_b == 0 and n_b > 1
    b_ax = (baxes if len(baxes) > 1 else baxes[0]) if shard_batch else None
    seq_ax = "model" if shard_batch else (
        ("data", "model") if "data" in mesh.axis_names else "model")

    def spec_for(names, leaf):
        name = _leaf_name(names)
        nd = len(leaf.shape)
        if name in ("k", "v", "xk", "xv"):
            # [count, B, n_kv, S, hd]
            S = leaf.shape[3]
            sa = seq_ax if isinstance(seq_ax, tuple) else (seq_ax,)
            ok = S % math.prod(_axis_size(mesh, a) for a in sa) == 0
            return Spec(None, b_ax, None, seq_ax if ok else None, None)
        if name == "state":          # [count, B, H, P, N]
            ax = "model" if _divisible(leaf.shape[2], mesh, "model") \
                else None
            return Spec(None, b_ax, ax, None, None)
        if name == "h":              # [count, B, w]
            ax = "model" if _divisible(leaf.shape[2], mesh, "model") \
                else None
            return Spec(None, b_ax, ax)
        if name == "conv":           # [count, B, k, ch]
            ax = "model" if _divisible(leaf.shape[3], mesh, "model") \
                else None
            return Spec(None, b_ax, None, ax)
        return Spec(*((None,) * nd))

    return _map_named(spec_for, cache_shape)


def serve_state_specs(state, mesh, kv_layout: str = "shard"
                      ) -> Dict[str, Spec]:
    """Spec per field of a ``PagedServeState`` (DESIGN.md §13).

    The page table and every other translation leaf stay replicated —
    the VBI address space is one logical space, host-global — while the
    physical pools (KV pages, ring frames, recurrent state) shard over
    ``model``.  Candidate dims per leaf come from
    ``core/vbi/kvcache.py::SERVE_STATE_SHARD_DIMS``; the first where
    ``shape[d]`` is divisible by and at least the axis size wins, else the
    leaf is replicated.  ``kv_layout='replicate'`` replicates
    everything."""
    from ..core.vbi.kvcache import SERVE_STATE_SHARD_DIMS
    n_m = _axis_size(mesh, "model")
    specs = {}
    for f in dataclasses.fields(state):
        leaf = getattr(state, f.name)
        nd = len(getattr(leaf, "shape", ()))
        spec = Spec(*((None,) * nd))
        if kv_layout == "shard" and n_m > 1:
            for d in SERVE_STATE_SHARD_DIMS.get(f.name, ()):
                size = leaf.shape[d] if d < nd else 0
                if size >= n_m and size % n_m == 0:
                    axes = [None] * nd
                    axes[d] = "model"
                    spec = Spec(*axes)
                    break
        specs[f.name] = spec
    return specs


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (the port's ``NamedSharding``): which dims of a
    leaf are cut into blocks, and this rank's block of each."""
    mesh: Any
    spec: Spec

    def blocks(self):
        """``[(dim, axes, n, index)]`` for each dim cut over more than one
        device."""
        out = []
        for i, ax in enumerate(self.spec):
            axes = () if ax is None else (ax if isinstance(ax, tuple)
                                          else (ax,))
            n = math.prod(_axis_size(self.mesh, a) for a in axes)
            if n > 1:
                idx = 0
                for a in axes:                      # row-major over axes
                    idx = idx * _axis_size(self.mesh, a) \
                        + self.mesh.coords.get(a, 0)
                out.append((i, axes, n, idx))
        return out

    @property
    def dim(self) -> Optional[int]:
        """The first cut dim (None for a whole leaf); on the serve path
        the one dim cut over ``model``."""
        b = self.blocks()
        return b[0][0] if b else None

    def axes(self) -> Tuple[str, ...]:
        """Every mesh axis some dim of the leaf is cut over (wide ones)."""
        return tuple(a for _, axes, _, _ in self.blocks() for a in axes
                     if _axis_size(self.mesh, a) > 1)

    def local(self, t: torch.Tensor, drop: int = 0) -> torch.Tensor:
        """This rank's block of the whole ``t`` (a view); ``drop`` leading
        dims of the leaf are already indexed away."""
        for i, _, n, idx in self.blocks():
            size = t.shape[i - drop]
            if size % n:
                raise ValueError(f"dim {i} of {tuple(t.shape)} does not "
                                 f"split into {n} blocks")
            t = t.narrow(i - drop, idx * (size // n), size // n)
        return t

    def whole(self, t: torch.Tensor, drop: int = 0) -> torch.Tensor:
        """The whole leaf from every rank's block ``t``: one all-gather
        per cut dim, over that dim's axes together (``model``, ``data``,
        or ``("pod", "data")``); ``drop`` as in :meth:`local`."""
        for i, axes, _, _ in self.blocks():
            t = self.mesh.all_gather(t, i - drop, axis=axes)
        return t


def shard_serve_state(mesh, kv_layout: str = "shard", device="cuda",
                      **pool):
    """This rank's blocks of a fresh ``PagedServeState`` whose geometry is
    ``pool`` (``kvcache.init_serve_state``'s arguments), cut by
    ``serve_state_specs``: the specs come from a ``meta`` state and each
    rank allocates only its blocks on ``device``.  Returns ``(state,
    {field: Sharding})``."""
    from ..core.vbi.kvcache import init_serve_state
    specs = serve_state_specs(init_serve_state(**pool, device="meta"), mesh,
                              kv_layout)
    shardings = {k: Sharding(mesh, sp) for k, sp in specs.items()}
    shard = {k: (sh.dim, mesh.shape["model"])
             for k, sh in shardings.items() if sh.dim is not None}
    return init_serve_state(**pool, device=device, shard=shard), shardings


def placement_hint(props: VBProps) -> dict:
    """Data-aware mapping hints from VBI property bits (Sec. 3.6.3
    analogue): latency-sensitive → replicate close; bandwidth-sensitive →
    shard wide; cold → host offload tier."""
    if props & VBProps.LATENCY_SENSITIVE:
        return {"tier": "hbm", "prefer": "replicate"}
    if props & VBProps.BANDWIDTH_SENSITIVE:
        return {"tier": "hbm", "prefer": "shard_wide"}
    if props & VBProps.COLD:
        return {"tier": "host", "prefer": "shard_wide"}
    return {"tier": "hbm", "prefer": "default"}


def shardings_of(spec_tree, mesh):
    """The spec tree as a tree of :class:`Sharding` on ``mesh``."""
    return _map_named(lambda _, s: Sharding(mesh, s), spec_tree)


class ParamBlocks(dict):
    """A params tree cut to one rank's blocks by :func:`shard_params`;
    ``mesh`` is the mesh it was cut for and ``specs`` the spec tree that
    cut it (``param_specs`` of the whole tree, which the blocks' own
    shapes could not give back)."""
    mesh: Any = None
    specs: Any = None


def shard_params(cfg: ModelConfig, params, mesh, device=None) -> ParamBlocks:
    """This rank's blocks of a whole params tree by ``param_specs``, on
    ``device`` (default: where ``params`` lives).  A cut leaf becomes a
    fresh contiguous copy of its block, so the whole tree may be dropped
    (or kept on the host) after; a whole leaf is moved, or stays the same
    tensor."""
    dev = params["embed"].device if device is None else torch.device(device)
    specs = param_specs(cfg, params, mesh)
    out = ParamBlocks(_cut(params, shardings_of(specs, mesh), dev))
    out.mesh, out.specs = mesh, specs
    return out


def _cut(tree, shardings, dev):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _cut(v, shardings[k], dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_cut(c, s, dev) for c, s in zip(tree, shardings)]
        return tuple(out) if isinstance(tree, tuple) else out
    if not shardings.blocks():
        return tree.to(dev)
    blk = shardings.local(tree)
    return torch.empty(blk.shape, dtype=blk.dtype, device=dev).copy_(blk)


class CacheBlocks(list):
    """Decode caches cut to one rank's blocks by :func:`cache_specs`
    (``models/model.py::init_cache`` under a mesh's ``logical_axes``);
    ``mesh`` is the mesh they were cut for and ``specs`` the spec tree
    that cut them: the decode step reads from it whether a cache's
    sequence is a block, which its length alone cannot say.  A plain list
    of caches is whole on every rank."""
    mesh: Any = None
    specs: Any = None


def shard_state(cfg: ModelConfig, state, mesh, device=None):
    """This rank's blocks of a whole train state ``{'params', 'opt'}``
    (numpy arrays or tensors, on the host or not) by ``state_specs``, on
    ``device`` (default: where ``params['embed']`` lives).  A cut leaf is
    a fresh contiguous copy of its block, never a view of the whole leaf;
    a whole numpy leaf is copied, a whole tensor is moved (or stays the
    same tensor, as in :func:`shard_params`)."""
    embed = state["params"]["embed"]
    dev = (torch.device(device) if device is not None else
           embed.device if isinstance(embed, torch.Tensor) else
           torch.device("cpu"))
    host = _map_named(lambda _, x: x if isinstance(x, torch.Tensor)
                      else torch.tensor(np.asarray(x)), state)
    return _cut(host, shardings_of(state_specs(cfg, state, mesh), mesh),
                dev)
