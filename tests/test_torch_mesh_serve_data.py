"""Serving on a mesh whose ``data`` axis is wider than 1
(``PagedEngine(mesh=Mesh(data=D, model=M))``, ``launch/serve.py
--mesh-shape DxM``) against the reference's greedy tokens and the port's
unmeshed engine.

The reference serves on any ``data x model`` mesh: ``param_specs`` cuts
each leaf's FSDP dim over ``data``, ``serve_state_specs`` cuts the pools
over ``model`` only (so they are whole over ``data``), and GSPMD cuts the
slot batch over ``data`` at the model's ``constrain(..., "batch", ...)``
sites.  The port does the same by hand: each rank runs its block of the
slots, gathers each layer's FSDP blocks, and gathers the new K|V and
recurrent rows and the final hidden rows whole over ``data``.

The meshes run as the port runs them: one process per device on a gloo
group, spawned by a module fixture (``_torch_mesh_data_worker.run``,
which imports no JAX): 2 ranks for 2x1, 4 ranks for 2x2 and 4x1.  The
parent computes the unmeshed engine's step logits before the ranks start
and the reference's tokens (``_torch_parity.jax_greedy``) while they run
(on an 8-core CPU the ranks took about 30 s either way, and the file
10 s less); the ranks meet through a file rendezvous, every collective
waits at most 60 s, and the parent kills ranks still alive after
``JOIN_S`` and fails their tests.

  * tokens equal the reference's greedy decode for qwen3-0.6b (dense),
    gemma3-12b (ring pool), recurrentgemma-9b (RG-LRU), mamba2-1.3b
    (Mamba-2) and mixtral-8x7b (MoE, ``moe_ep``), under ``kv_layout``
    shard and replicate and horizons 1 and 8, 4 slots; every rank returns
    the same tokens, stats and trace;
  * one decode step's logits are within ``LOGIT_TOL`` of the unmeshed
    engine's;
  * after a serve every ``data`` rank's pools are bit-equal; a block image
    through the pool is the unmeshed pool's, bytes and CRC;
  * one decode step's collectives, calls and bytes by kind, equal
    :func:`expected_collectives` (PERF.md § 6);
  * 3 slots on 2x1, which ``data`` does not divide, run whole on every
    rank (the reference's fallback rule);
  * preemption and host swap on 2x2 equal the roomy run;
  * the launcher with ``--mesh-shape 2x1`` and ``2x2``, with and without
    ``--disagg``, gives the unmeshed launcher's tokens;
  * in this process: ``shard_params`` on 2x1, 2x2 and 4x1 cuts each leaf
    as the reference's ``param_specs`` does, an engine keeps only its
    ``data x model`` blocks, ``constrain`` cuts a ``batch`` dim (and
    keeps rows the axes do not divide whole), the launcher refuses the
    kernel on a ``data`` mesh, int8 weights build on one.
"""
import dataclasses
import math
import multiprocessing as mp
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

import _torch_mesh_data_worker as W
from _torch_parity import jax_greedy, one_torch_thread  # noqa: F401
from repro.distributed import sharding as js
from repro.launch.serve import serve_config as ref_serve_config
from repro.models import model as jm
from repro_torch import tree
from repro_torch.distributed import axes
from repro_torch.distributed.sharding import (ParamBlocks, Spec,
                                              param_specs,
                                              serve_state_specs,
                                              shard_params)
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import CountingMesh, Mesh
from repro_torch.models.model import init_params
from repro_torch.serve.engine import pool_geometry, trace_token_step

WORLDS = (2, 4)
MESHES = [m for w in WORLDS for m in W.MESHES[w]]
#: the ranks' time limit (each world's whole run of cases)
JOIN_S = 240
#: one decode step's logits, meshed vs unmeshed, and a block's K/V and
#: recurrent state (readings at most 3.3e-6 over every case; about 3x)
LOGIT_TOL = 1e-5


def _port(arch):
    """(port cfg, port params on the CPU) for ``arch``'s serve config."""
    cfg = tserve.serve_config(arch)
    return cfg, init_params(cfg, seed=0, device="cpu")


def _reference_params(arch, tp):
    """The port's params as the reference's params tree: the same numbers,
    leaf for leaf in ``jax.tree`` order."""
    cfg = ref_serve_config(arch)
    shape = jax.eval_shape(lambda: jm.init_params(cfg, jax.random.key(0)))
    leaves = [jnp.asarray(t.numpy()) for t in tree.leaves(tp)]
    return cfg, jax.tree.unflatten(jax.tree.structure(shape), leaves)


def _spec_leaves(specs):
    """A port spec tree's specs in ``jax.tree`` order (a Spec is a
    leaf)."""
    if isinstance(specs, Spec):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    return [s for c in specs for s in _spec_leaves(c)]


def _prompts(arch, vocab):
    """Four seeded prompts of 5 tokens (seeded by a stable hash of the
    arch)."""
    rng = np.random.default_rng(zlib.crc32(arch.encode()) + 31)
    return [rng.integers(0, vocab, 5).tolist() for _ in range(W.N_PROMPTS)]


def _world(mesh):
    return math.prod(mesh)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Compute the unmeshed engine's step, spawn the 2- and 4-rank
    groups, compute the reference's tokens while they run, and gather
    each rank's results: ``(reference, plain, {world: [rank results] or
    the error})``."""
    root = tmp_path_factory.mktemp("mesh_data")
    inputs, plain = {}, {}
    for arch in W.ARCHS:
        cfg, tp = _port(arch)
        prompts = _prompts(arch, cfg.vocab)
        logits, first, img, _ = W.step_logits(W._engine(cfg, tp), prompts)
        fb, _, _, _ = W.step_logits(
            W._engine(cfg, tp, max_seqs=W.FALLBACK_SLOTS),
            prompts[:W.FALLBACK_SLOTS])
        inputs[arch] = {"cfg": cfg, "params": tp, "prompts": prompts,
                        "image": img}
        plain[arch] = {"logits": logits, "first": first, "image":
                       W._img_record(img), "fallback_logits": fb}
    torch.save(inputs, root / "inputs.pt")
    ctx = mp.get_context("spawn")
    procs = {}
    for world in WORLDS:
        d = root / f"w{world}"
        d.mkdir()
        procs[world] = [ctx.Process(
            target=W.run, args=(r, world, str(d / "rdzv"),
                                str(root / "inputs.pt"), str(d)),
            daemon=True) for r in range(world)]
        for p in procs[world]:
            p.start()
    deadline = time.monotonic() + JOIN_S
    ref = {}
    for arch in W.ARCHS:
        rcfg, jp = _reference_params(arch, inputs[arch]["params"])
        ref[arch] = {i: jax_greedy(rcfg, jp, p, W.MAX_NEW)
                     for i, p in enumerate(inputs[arch]["prompts"])}
    results = {}
    for world, ps in procs.items():
        for p in ps:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(ps) if p.is_alive()]
        for p in ps:
            if p.is_alive():
                p.kill()
                p.join(10)
        d = root / f"w{world}"
        errs = [f"rank {r}:\n{(d / f'rank{r}.err').read_text()}"
                for r in range(world) if (d / f"rank{r}.err").exists()]
        if hung or errs or any(p.exitcode for p in ps):
            results[world] = (f"{world} ranks: hung {hung} (killed after "
                              f"{JOIN_S} s), exit codes "
                              f"{[p.exitcode for p in ps]}\n"
                              + "\n".join(errs))
        else:
            results[world] = [torch.load(d / f"rank{r}.pt",
                                         weights_only=False)
                              for r in range(world)]
    return ref, plain, results


def _ranks(spawned, world):
    res = spawned[2][world]
    if isinstance(res, str):
        pytest.fail(res)
    return res


def _label(mesh):
    return "x".join(map(str, mesh))


# --------------------------------------------------------------------------
# the collectives of one decode token step
# --------------------------------------------------------------------------
def _pool_rows(cfg, eng_whole, mesh, layout):
    """Bytes of one slot's row of each pool leaf on a rank of ``mesh``
    under ``layout``: the whole leaf's per-slot elements, divided by
    ``model`` where ``serve_state_specs`` cuts it."""
    specs = serve_state_specs(eng_whole.state, Mesh(*mesh, "cpu"), layout)
    rows = {}
    for name in ("k_pages", "k_ring", "rg_h", "rg_conv", "ssm_state",
                 "ssm_conv"):
        leaf = getattr(eng_whole.state, name)
        per = (math.prod(leaf.shape[3:]) if name.startswith("k_")
               else math.prod(leaf.shape[2:]))
        rows[name] = per // (mesh[1] if "model" in specs[name] else 1) * 4
    return rows


def _fsdp_gathers(cfg, params, mesh):
    """(calls, bytes) of a token step's FSDP gathers on ``mesh``: one
    all-gather for each layer that has a leaf cut over ``data`` (its
    leaves are all float32), of this rank's blocks of those leaves."""
    sizes = {"data": mesh[0], "model": mesh[1], None: 1}
    specs = param_specs(cfg, params, Mesh(*mesh, "cpu"))
    calls = nbytes = 0
    for sp, ss in zip(params["stages"], specs["stages"]):
        for entry, spec in zip(sp, ss):
            cut = [(leaf, s) for leaf, s in zip(tree.leaves(entry),
                                                _spec_leaves(spec))
                   if "data" in s]
            calls += cut[0][0].shape[0] if cut else 0
            nbytes += sum(leaf.nbytes // math.prod(sizes[a] for a in s)
                          for leaf, s in cut)
    return calls, nbytes


def expected_collectives(cfg, params, mesh, layout, S):
    """``{kind: (calls, bytes)}`` of one decode token step on a ``data x
    model`` mesh whose ``data`` width D divides the S slots (PERF.md §
    6); B = S / D rows a rank.  Bytes are what this rank sends
    (float32 activations).

    Over ``data``, all-gathers only: one per layer for the blocks of its
    leaves that ``param_specs`` cuts over ``data`` (FSDP), one per attention
    layer (the new K|V rows) and per RG-LRU or Mamba-2 layer (the new
    state rows), B rows of the pool's per-slot width each, and one of the
    final hidden rows (B x d).  Over a wide ``model`` axis (the dense and
    MoE stacks): one all-reduce of the embedding and of each ``wo`` and
    ``w2`` row block (B x d each); under ``replicate`` one all-gather of
    q|k|v a layer; one all-gather of the logits' vocab blocks (S x V /
    M); two all-to-alls an MoE layer of the [E, cap, d] buffer, cap = B
    under the engine's capacity bump."""
    D, M = mesh
    B = S // D
    n = {k: [0, 0] for k in ("all_reduce", "all_gather", "all_to_all")}
    n["all_gather"] = list(_fsdp_gathers(cfg, params, mesh))
    rows = _pool_rows(cfg, W._engine(cfg, params), mesh, layout)
    kinds = [sp for st in cfg.stages() for _ in range(st.count)
             for sp in st.period]
    n_attn = sum(sp.kind in ("attn", "local") for sp in kinds)
    n_rg = sum(sp.kind == "rglru" for sp in kinds)
    n_ssm = sum(sp.kind == "mamba" for sp in kinds)
    n_moe = sum(bool(sp.moe) for sp in kinds)
    n_mlp = sum(sp.kind != "mamba" and not sp.moe for sp in kinds)
    kv = rows["k_pages"] or rows["k_ring"]
    n["all_gather"][0] += n_attn + n_rg + n_ssm + 1
    n["all_gather"][1] += B * (n_attn * 2 * kv
                               + n_rg * (rows["rg_h"] + rows["rg_conv"])
                               + n_ssm * (rows["ssm_state"]
                                          + rows["ssm_conv"])
                               + cfg.d_model * 4)
    if M > 1:
        assert not n_rg and not n_ssm, "the formula covers attention stacks"
        n_ar = 1 + n_attn + n_mlp
        n["all_reduce"] = [n_ar, n_ar * B * cfg.d_model * 4]
        qkv = (cfg.n_heads + 2 * cfg.n_kv) * cfg.head_dim // M
        rep = layout == "replicate"
        n["all_gather"][0] += n_attn * rep + 1
        n["all_gather"][1] += n_attn * rep * B * qkv * 4 \
            + S * cfg.vocab // M * 4
        n["all_to_all"] = [2 * n_moe,
                           2 * n_moe * cfg.n_experts * B * cfg.d_model * 4]
    return {k: tuple(v) for k, v in n.items()}


# --------------------------------------------------------------------------
# the spawned meshes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("k", W.HORIZONS)
@pytest.mark.parametrize("layout", W.LAYOUTS)
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=_label)
def test_data_mesh_tokens_match_reference(spawned, mesh, arch, layout, k):
    ranks = _ranks(spawned, _world(mesh))
    runs = [r["meshes"][mesh]["tokens"][(mesh, arch, layout, k)]
            for r in ranks]
    assert runs[0]["out"] == spawned[0][arch], \
        f"{_label(mesh)} {arch} {layout} K={k}: tokens differ from the " \
        f"reference"
    for r, run in enumerate(runs[1:], 1):
        for key in ("out", "stats", "engine_stats", "free", "trace",
                    "placement"):
            assert run[key] == runs[0][key], f"rank {r} {key} differs"
    run = runs[0]
    assert run["free"][0] == run["free"][1]
    assert run["kv_layout"] == layout
    assert run["placement"] == tuple(f"cpu:{r}" for r in range(len(ranks)))
    calls = {kind: c["calls"] for kind, c in run["collectives"].items()}
    assert calls["all_gather"] > 0, calls
    assert (calls["all_reduce"] > 0) == (mesh[1] > 1), calls
    assert (calls["all_to_all"] > 0) == (mesh[1] > 1
                                         and arch == "mixtral-8x7b"), calls
    if k == 8:
        assert run["trace"], "the traced run recorded no event"


@pytest.mark.parametrize("layout", W.LAYOUTS)
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=_label)
def test_data_mesh_logits_match_unmeshed_engine(spawned, mesh, arch,
                                                layout):
    want = spawned[1][arch]
    got = [r["meshes"][mesh]["logits"][(mesh, arch, layout)]
           for r in _ranks(spawned, _world(mesh))]
    err = float((got[0]["logits"] - want["logits"]).abs().max())
    assert err <= LOGIT_TOL, f"{_label(mesh)} {arch} {layout}: {err:.3e}"
    assert got[0]["first"] == want["first"]
    for g in got[1:]:
        assert torch.equal(g["logits"], got[0]["logits"]), \
            "ranks sample from different logits"


@pytest.mark.parametrize("layout", W.LAYOUTS)
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=_label)
def test_data_mesh_pools_equal_over_data(spawned, mesh, arch, layout):
    """After a serve every ``data`` rank of a ``model`` index holds the
    same pools, bit for bit: the rows each rank computed were gathered
    whole before the write."""
    ranks = _ranks(spawned, _world(mesh))
    by_model = {}
    for r in ranks:
        by_model.setdefault(r["coords"][mesh]["model"], []).append(
            r["meshes"][mesh]["pools"][(mesh, arch, layout)])
    assert len(by_model) == mesh[1]
    for pools in by_model.values():
        assert len(pools) == mesh[0]
        for other in pools[1:]:
            for name, t in pools[0].items():
                assert torch.equal(other[name], t), name


@pytest.mark.parametrize("layout", W.LAYOUTS)
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=_label)
def test_data_mesh_block_image_equals_unmeshed(spawned, mesh, arch, layout):
    """The unmeshed pool's image of a block (a prompt and one decoded
    token), imported into the mesh's pool and exported again, is the same
    bytes and CRC; the mesh's own image of that block is the same on
    every rank and within the logit tolerance of the unmeshed one."""
    plain = spawned[1][arch]["image"]
    imgs = [r["meshes"][mesh]["images"][(mesh, arch, layout)]
            for r in _ranks(spawned, _world(mesh))]
    for img in imgs:
        back = img["round_trip"]
        assert back["checksum"] == plain["checksum"]
        for key in ("k", "v"):
            assert back[key].tobytes() == plain[key].tobytes()
        assert (back["aux"] is None) == (plain["aux"] is None)
        for a, b in zip(back["aux"] or (), plain["aux"] or ()):
            assert a.tobytes() == b.tobytes()
        assert img["own"]["checksum"] == imgs[0]["own"]["checksum"]
    own = imgs[0]["own"]
    for a, b in zip([own["k"], own["v"], *(own["aux"] or ())],
                    [plain["k"], plain["v"], *(plain["aux"] or ())]):
        np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_TOL)


#: every stack on the meshes with a 1-wide ``model`` axis; the attention
#: stacks (dense and MoE) on 2x2
COLLECTIVE_CASES = [(m, a, lay) for m in MESHES for a in W.ARCHS
                    for lay in W.LAYOUTS
                    if m[1] == 1 or a in ("qwen3-0.6b", "mixtral-8x7b")]


@pytest.mark.parametrize("mesh,arch,layout", COLLECTIVE_CASES,
                         ids=lambda v: _label(v) if isinstance(v, tuple)
                         else v)
def test_data_mesh_collectives_per_token_step(spawned, mesh, arch, layout):
    cfg, tp = _port(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=max(
            cfg.capacity_factor, cfg.n_experts / cfg.top_k))
    want = expected_collectives(cfg, tp, mesh, layout, W.POOL["max_seqs"])
    for r in _ranks(spawned, _world(mesh)):
        step = r["meshes"][mesh]["logits"][(mesh, arch, layout)]["step"]
        got = {k: (c["calls"], c["bytes"]) for k, c in step.items()
               if k in want}
        assert got == want, f"{_label(mesh)} {arch} {layout}"
        assert all(step[k]["calls"] == 0 for k in step if k not in want)


@pytest.mark.parametrize("layout", W.LAYOUTS)
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=_label)
def test_counting_mesh_trace_equals_gloo_step(spawned, mesh, arch, layout):
    """The dry run's trace of one decode token step (rank 0 of a
    ``CountingMesh`` on meta, ``serve/engine.py::trace_token_step``)
    makes the collectives, calls and bytes by kind, that the gloo step
    measured on every rank, on every mesh the formula covers and the
    recurrent stacks on 2x2 beside them."""
    cfg, tp = _port(arch)
    shape = {"data": mesh[0], "model": mesh[1]}
    eng = W._engine(cfg, tp, CountingMesh(shape, device_type="cpu"), layout)
    pool = pool_geometry(eng.cfg, eng.geom, eng.n_pages, eng.page_size,
                         eng.max_seqs, eng.max_pages)
    _, counting = trace_token_step(eng.cfg, eng.geom, shape, layout,
                                   eng.params, pool, eng.max_pages)
    for r in _ranks(spawned, _world(mesh)):
        step = r["meshes"][mesh]["logits"][(mesh, arch, layout)]["step"]
        assert step == counting.collectives


@pytest.mark.parametrize("arch", W.FALLBACK_ARCHS)
def test_data_mesh_fallback_runs_whole_rows(spawned, arch):
    """3 slots on 2x1: ``data`` does not divide them, so every rank runs
    every slot (the MoE on the local path) and nothing but the layers'
    FSDP blocks is gathered; tokens equal the reference's, logits the
    unmeshed engine's within ``LOGIT_TOL``."""
    cfg, tp = _port(arch)
    n_fsdp, _ = _fsdp_gathers(cfg, tp, (2, 1))
    want = {i: spawned[0][arch][i] for i in range(W.FALLBACK_SLOTS)}
    for r in _ranks(spawned, 2):
        got = r["fallback"][arch]
        assert got["out"] == want
        err = float((got["logits"]
                     - spawned[1][arch]["fallback_logits"]).abs().max())
        assert err <= LOGIT_TOL, err
        assert {k: c["calls"] for k, c in got["step"].items()
                if c["calls"]} == {"all_gather": n_fsdp}


def test_data_mesh_preemption_and_swap_exactness(spawned):
    """tests/test_mesh_serve.py:128-149 on the 2x2 sharded pool: discard
    and host-swap resume equal the roomy run."""
    for rank in _ranks(spawned, 4):
        p = rank["pressure"]
        assert p["preemptions"] >= 1 and p["swap_ins"] >= 1
        assert p["discard"] == p["roomy"] and p["swapped"] == p["roomy"]
        assert p["tier_used"] == 0
        assert p["free"] == (7, 7)


@pytest.mark.parametrize("topology", ("unified", "disagg"))
@pytest.mark.parametrize("world", WORLDS)
def test_data_mesh_launcher_matches_unmeshed(spawned, world, topology):
    """``main(['--mesh-shape', '2x1' or '2x2', '--kv-layout', 'shard',
    ...])`` gives the unmeshed launcher's tokens on every rank, on the
    plain batched attention, with one cut tree for both ``--disagg``
    engines."""
    for rank in _ranks(spawned, world):
        run = rank["launcher"][topology]
        assert run["mesh"] == run["plain"] and len(run["mesh"]) == 4
        assert run["blocks"] and run["one_tree"]
        assert run["param_bytes"] < run["whole_bytes"]
        assert run["attn_impl"] == "gather"
        assert run["collectives"]["all_gather"]["calls"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_data_mesh_ranks_never_load_jax(spawned, world):
    assert not any(r["jax_loaded"] for r in _ranks(spawned, world))


# --------------------------------------------------------------------------
# in this process: the cut, the engine's blocks, constrain, the launcher
# --------------------------------------------------------------------------
def _ref_specs(arch, mesh):
    """The reference's ``param_specs`` of ``arch``'s serve params on an
    ``AbstractMesh`` of ``mesh``, as tuples in ``jax.tree`` order."""
    rcfg, jp = _reference_params(arch, _port(arch)[1])
    specs = js.param_specs(rcfg, jp, AbstractMesh(mesh, ("data", "model")))
    return [tuple(s) for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))]


def _block_of(whole, spec, coords, sizes):
    """``whole``'s block at ``coords`` under a reference spec."""
    for dim, ax in enumerate(spec):
        axes_ = () if ax is None else (ax if isinstance(ax, tuple)
                                       else (ax,))
        n, idx = 1, 0
        for a in axes_:
            n *= sizes[a]
            idx = idx * sizes[a] + coords[a]
        if n > 1:
            blk = whole.shape[dim] // n
            whole = whole.narrow(dim, idx * blk, blk)
    return whole


@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=_label)
def test_shard_params_cuts_as_the_reference_specs(mesh, arch):
    """Each rank's ``shard_params`` blocks are the whole leaves cut by the
    reference's ``param_specs`` at its coordinates (ranks built without a
    process group: cutting makes no collective); the spec tree the blocks
    carry is the port's ``param_specs``, equal to the reference's."""
    cfg, tp = _port(arch)
    ref = _ref_specs(arch, mesh)
    whole = tree.leaves(tp)
    sizes = {"data": mesh[0], "model": mesh[1]}
    for r in range(_world(mesh)):
        m = Mesh(*mesh, "cpu", rank=r)
        blocks = shard_params(cfg, tp, m)
        assert [tuple(s) for s in _spec_leaves(blocks.specs)] == ref
        for w, b, spec in zip(whole, tree.leaves(blocks), ref,
                              strict=True):
            assert torch.equal(b, _block_of(w, spec, m.coords, sizes))


@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=_label)
def test_data_mesh_engine_holds_only_its_blocks(mesh, arch):
    """Given the whole params, an engine on a ``data x model`` rank keeps
    only its blocks: a leaf cut over both axes is 1 / (D x M) of the
    whole leaf's bytes, in storage of its own; no whole leaf of a cut
    one stays alive through the engine."""
    cfg, tp = _port(arch)
    whole = tree.leaves(tp)
    specs = _spec_leaves(param_specs(cfg, tp, Mesh(*mesh, "cpu")))
    sizes = {"data": mesh[0], "model": mesh[1], None: 1}
    n_both = 0
    for r in range(_world(mesh)):
        eng = W._engine(cfg, tp, Mesh(*mesh, "cpu", rank=r), "shard")
        assert isinstance(eng.params, ParamBlocks)
        held = 0
        for w, b, spec in zip(whole, tree.leaves(eng.params), specs,
                              strict=True):
            held += b.nbytes
            n = math.prod(sizes[a] for a in spec)
            if n == 1:
                assert b is w
                continue
            n_both += {"data", "model"} <= set(spec)
            assert b.nbytes * n == w.nbytes and b.is_contiguous()
            assert b.untyped_storage().nbytes() == b.nbytes
        assert held < sum(t.nbytes for t in whole)
    assert n_both > 0 or mesh[1] == 1


def test_constrain_cuts_the_batch_axes():
    """On a ``data x model`` rank (no process group: slicing makes no
    collective) a dim named ``batch`` ends as this rank's block over
    ``data`` (a view), rows the axes do not divide stay whole, and
    ``data_axis`` gives (mesh, size, index); ``batch_whole`` leaves whole
    rows alone."""
    x = torch.arange(24.0).reshape(4, 6)
    for r in range(4):
        mesh = Mesh(2, 2, "cpu", rank=r)
        with axes.logical_axes(mesh):
            d = mesh.coords["data"]
            assert axes.data_axis() == (mesh, 2, d)
            blk = axes.constrain(x, "batch", None)
            assert torch.equal(blk, x[2 * d:2 * d + 2])
            assert blk.data_ptr() == x[2 * d].data_ptr()
            odd = x[:3]
            assert axes.constrain(odd, "batch", None) is odd
            assert axes.batch_whole((odd,), 3)[0] is odd
        assert all(c["calls"] == 0 for c in mesh.collectives.values())
    with axes.logical_axes(Mesh(1, 2, "cpu")):
        assert axes.data_axis() is None
        assert axes.constrain(x, "batch", None) is x
    assert axes.data_axis() is None


def test_launcher_refuses_the_kernel_on_a_data_mesh(monkeypatch, capsys):
    """``--mesh-shape 2x1 --attn-impl kernel`` is a usage error naming the
    kernel (the reference refuses it on any mesh of more than one
    device), and ``--mesh-shape 2x1`` outside ``torchrun`` names the
    processes it needs."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for extra in (["--attn-impl", "kernel"], []):
        with pytest.raises(SystemExit) as e:
            tserve.main(["--device", "cpu", "--mesh-shape", "2x1"] + extra)
        assert e.value.code == 2
    err = capsys.readouterr().err
    assert "runs 2 processes" in err and "torchrun --nproc-per-node" in err
    assert "--attn-impl kernel is not supported" in err


def test_q8_weights_build_on_a_data_axis():
    """int8 weights are refused only on a wide ``model`` axis: on a 2x1
    rank the engine cuts each ``q8`` leaf's FSDP rows over ``data`` and
    keeps the scales whole."""
    from repro_torch.models.quantized import quantize_serving_params
    cfg, tp = _port("qwen3-0.6b")
    q = quantize_serving_params(tp)
    eng = W._engine(cfg, q, Mesh(2, 1, "cpu", rank=1), "shard")
    wq = eng.params["stages"][0][0]["attn"]["wq"]
    whole = q["stages"][0][0]["attn"]["wq"]
    assert wq["q8"].shape[-2] * 2 == whole["q8"].shape[-2]
    assert wq["s"].shape == whole["s"].shape
