"""The port's sharding rules (``repro_torch/distributed``) against the
reference's, leaf by leaf, in one process.

The reference's ``param_specs``, ``cache_specs``, ``serve_state_specs``,
``batch_axes_for``, ``placement_hint`` and the ``logical_axes`` mapping
run on ``jax.sharding.AbstractMesh`` meshes (no devices needed), the
port's on ``launch/mesh.py::Mesh`` objects of the same shape (no process
group needed: a spec reads only the shape).  Inputs: the smoke config of
every architecture (dense, ring, recurrent, MoE and encoder-decoder param
trees alike) on meshes 1x1, 1x2, 1x4, 2x2 and 2x4.  Specs are compared
as tuples, keyed by their ``jax.tree`` path.  Then the port's cutting:
the blocks ``shard_params`` and ``shard_serve_state`` give each rank put
back together are the whole tree.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs import smoke_config as ref_smoke_config
from repro.core.vbi import kvcache as jk
from repro.core.vbi.address_space import VBProps as JVBProps
from repro.distributed import axes as jaxes
from repro.distributed import sharding as js
from repro.models import model as jm
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.core.vbi import kvcache as tk
from repro_torch.core.vbi.address_space import VBProps
from repro_torch.distributed import axes as taxes
from repro_torch.distributed import sharding as ts
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as tm

MESHES = ((1, 1), (1, 2), (1, 4), (2, 2), (2, 4))


def _meshes(data, model):
    return (AbstractMesh((data, model), ("data", "model")),
            Mesh(data, model, "cpu"))


def _ref_leaves(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in flat]


def _port_leaves(specs, path=""):
    """``[(path, spec)]`` in ``jax.tree`` order, a Spec being a leaf."""
    if isinstance(specs, ts.Spec):
        return [(path, tuple(specs))]
    if isinstance(specs, dict):
        return [kl for k in sorted(specs)
                for kl in _port_leaves(specs[k], f"{path}[{k!r}]")]
    return [kl for i, c in enumerate(specs)
            for kl in _port_leaves(c, f"{path}[{i}]")]


_REF_SHAPES = {}


def _ref_shapes(arch):
    """The reference's param and cache shapes (``jax.eval_shape``)."""
    if arch not in _REF_SHAPES:
        cfg = ref_smoke_config(arch)
        _REF_SHAPES[arch] = (
            cfg,
            jax.eval_shape(lambda: jm.init_params(cfg, jax.random.key(0))),
            jax.eval_shape(lambda: jm.init_cache(cfg, 4, 32)))
    return _REF_SHAPES[arch]


_PORT = {}


def _port_trees(arch):
    if arch not in _PORT:
        cfg = smoke_config(arch)
        _PORT[arch] = (cfg, tm.init_params(cfg, seed=0, device="cpu"),
                       tm.init_cache(cfg, 4, 32, device="cpu"))
    return _PORT[arch]


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh_shape):
    jmesh, tmesh = _meshes(*mesh_shape)
    jcfg, jparams, _ = _ref_shapes(arch)
    tcfg, tparams, _ = _port_trees(arch)
    ref = _ref_leaves(js.param_specs(jcfg, jparams, jmesh))
    got = _port_leaves(ts.param_specs(tcfg, tparams, tmesh))
    assert got == ref
    assert [p for p, _ in tree.leaves_with_path(tparams)] == \
        [p for p, _ in ref]


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch, mesh_shape):
    jmesh, tmesh = _meshes(*mesh_shape)
    jcfg, _, jcache = _ref_shapes(arch)
    tcfg, _, tcache = _port_trees(arch)
    for batch in (1, 4):
        ref = _ref_leaves(js.cache_specs(jcfg, jcache, jmesh, batch))
        got = _port_leaves(ts.cache_specs(tcfg, tcache, tmesh, batch))
        assert got == ref, f"batch {batch}"


def test_quantized_leaf_specs_match_reference():
    """The ``q8``/``s`` leaves of a quantized tree follow their matmul (a
    hand-made tree: the rules read names and shapes only)."""
    def leaf(*shape):
        return jax.ShapeDtypeStruct(shape, np.float32)

    def tleaf(*shape):
        return torch.zeros(shape)

    names = {"wq": (4, 64, 64), "wo": (4, 64, 64), "w2": (4, 96, 64),
             "lm_head": (64, 256), "router": (64, 8)}
    for data, model in MESHES:
        jmesh, tmesh = _meshes(data, model)
        for n_experts in (0, 4):
            cfg = dataclasses.replace(smoke_config("qwen3-0.6b"),
                                      n_experts=n_experts)
            jcfg = dataclasses.replace(ref_smoke_config("qwen3-0.6b"),
                                       n_experts=n_experts)
            jt = {k: {"q8": leaf(*s), "s": leaf(*s[:-2], s[-1])}
                  for k, s in names.items()}
            tt = {k: {"q8": tleaf(*s), "s": tleaf(*s[:-2], s[-1])}
                  for k, s in names.items()}
            assert _port_leaves(ts.param_specs(cfg, tt, tmesh)) == \
                _ref_leaves(js.param_specs(jcfg, jt, jmesh))


#: pool geometries: kv heads divisible or not, head_dim divisible or not,
#: every recurrent leaf present
STATES = (
    dict(n_kv=2, head_dim=16, n_rg=1, rnn_width=64, n_ssm=1, ssm_heads=4,
         ssm_conv_ch=160),
    dict(n_kv=1, head_dim=16, n_rg=1, rnn_width=6, n_ssm=1, ssm_heads=3,
         ssm_conv_ch=10),
    dict(n_kv=4, head_dim=6, n_rg=0, rnn_width=0, n_ssm=0, ssm_heads=0,
         ssm_conv_ch=0),
    dict(n_kv=3, head_dim=5, n_rg=1, rnn_width=8, n_ssm=1, ssm_heads=8,
         ssm_conv_ch=12),
)
BASE = dict(n_layers=2, n_pages=9, page_size=4, max_seqs=2,
            max_pages_per_seq=4, n_ring_layers=1, ring_pages=2, ssm_proj=3,
            ssm_state_size=4)


@pytest.mark.parametrize("layout", ("shard", "replicate"))
@pytest.mark.parametrize("geom", range(len(STATES)))
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_serve_state_specs_match_reference(mesh_shape, geom, layout):
    jmesh, tmesh = _meshes(*mesh_shape)
    kw = dict(BASE, **STATES[geom])
    ref = js.serve_state_specs(jk.init_serve_state(**kw), jmesh, layout)
    got = ts.serve_state_specs(tk.init_serve_state(device="cpu", **kw),
                               tmesh, layout)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in ref.items()}
    assert tk.SERVE_STATE_SHARD_DIMS == jk.SERVE_STATE_SHARD_DIMS


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_axes_and_hints_match_reference(mesh_shape):
    jmesh, tmesh = _meshes(*mesh_shape)
    assert ts.batch_axes_for(tmesh) == js.batch_axes_for(jmesh)
    for n_experts in (0, 2, 4, 8):
        # the port names no "seq" axis: ``cache_specs`` decides where a
        # decode cache's sequence is cut, and the reference's other
        # entries do not depend on its ``seq_shard``
        for seq_shard in (False, True):
            with jaxes.logical_axes(jmesh, n_experts, seq_shard):
                ref = dict(jaxes._AXES.get()["map"])
            del ref["seq"]
            with taxes.logical_axes(tmesh, n_experts):
                got = dict(taxes._AXES.get()["map"])
            assert got == ref
    assert taxes._AXES.get() is None
    # every subset of the three bits the hint reads, beside each flag
    keys = (VBProps.LATENCY_SENSITIVE, VBProps.BANDWIDTH_SENSITIVE,
            VBProps.COLD)
    for other in [VBProps.NONE, *VBProps]:
        for bits in range(8):
            props = other
            for i, f in enumerate(keys):
                if bits >> i & 1:
                    props |= f
            assert ts.placement_hint(props) == js.placement_hint(
                JVBProps(int(props)))


@pytest.mark.parametrize("arch", ("qwen3-0.6b", "gemma3-12b",
                                  "recurrentgemma-9b", "mamba2-1.3b"))
@pytest.mark.parametrize("model", (2, 4))
def test_cut_blocks_put_back_are_whole(arch, model):
    """Each rank's blocks of ``shard_params`` and of the pool the engine
    allocates (``shard_serve_state``; ranks built without a process group:
    cutting needs none), stacked back along their spec's dim, are the
    whole tree; a cut param leaf is a fresh copy, not a view of the whole
    one."""
    cfg, params, _ = _port_trees(arch)
    meshes = [Mesh(1, model, "cpu", rank=r) for r in range(model)]
    specs = _port_leaves(ts.param_specs(cfg, params, meshes[0]))
    cuts = [tree.leaves(ts.shard_params(cfg, params, m)) for m in meshes]
    for i, (path, whole) in enumerate(tree.leaves_with_path(params)):
        spec = specs[i][1]
        if "model" not in spec:
            assert all(c[i] is whole for c in cuts), path
            continue
        d = spec.index("model")
        assert torch.equal(torch.cat([c[i] for c in cuts], d), whole), path
        assert all(c[i].untyped_storage().data_ptr()
                   != whole.untyped_storage().data_ptr() for c in cuts), path
    kw = dict(BASE, **STATES[0])
    state = tk.init_serve_state(device="cpu", **kw)
    blocks = [ts.shard_serve_state(m, "shard", "cpu", **kw) for m in meshes]
    for f in dataclasses.fields(state):
        whole = getattr(state, f.name)
        sh = blocks[0][1][f.name]
        if sh.dim is None:
            assert all(torch.equal(getattr(b[0], f.name), whole)
                       for b in blocks), f.name
            continue
        got = torch.cat([getattr(b[0], f.name) for b in blocks], sh.dim)
        assert torch.equal(got, whole), f.name
