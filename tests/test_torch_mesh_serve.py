"""Serving on a device mesh in the port (``PagedEngine(mesh=, kv_layout=)``,
``launch/mesh.py``, ``distributed/``) against the reference's greedy
tokens and the port's unmeshed engine.

The 1x2 and 1x4 meshes run as the port runs them: one process per mesh
device on a gloo group.  The module spawns one group per world size
(``_torch_mesh_worker.run``), each running every case in its ranks, and
the tests read what the ranks wrote.  The params are the port's seeded
``init_params``; the parent hands the same numbers to the reference (in
``jax.tree`` leaf order, ``repro_torch/tree.py``) and computes its greedy
tokens (``_torch_parity.jax_greedy``) before the ranks start; the ranks
never load JAX.  The ranks meet through a file rendezvous (no TCP port
to collide between test workers), every collective waits at most 60 s,
and the parent kills ranks still alive after ``JOIN_S`` and fails their
tests.

  * tokens equal the reference's greedy decode for qwen3-0.6b, gemma3-12b
    (ring pool), recurrentgemma-9b, mamba2-1.3b, mixtral-8x7b (ring pool,
    MoE) and qwen3-moe-235b-a22b (MoE, qk-norm), under ``kv_layout``
    shard and replicate and horizons 1 and 8, and every rank returns the
    same tokens, stats and trace;
  * one decode step's logits are within ``LOGIT_TOL`` of the unmeshed
    engine's (a row block's partial products and their all-reduce sum in
    another order than one product);
  * each pool leaf is held as its local shard: the whole shape divided by
    the mesh on the dim ``serve_state_specs`` names;
  * preemption and host swap on the 1x4 sharded pool equal the roomy run;
    a block image through the sharded pool is the unmeshed pool's, bytes
    and CRC; blocks carry the mesh's placement and ``VBProps.SHARDED``;
  * the refusals (the kernel on a wide ``model`` axis and on a
    ``data``-only mesh) and the launcher (``--mesh-shape 1x2 --kv-layout
    shard``, with and without ``--disagg``) in 2 ranks; a ``data`` axis
    wider than 1 serves (``test_torch_mesh_serve_data.py``);
  * ``kv_layout='auto'`` on 1x2 and 1x4: every rank builds, with the
    same choice and report, no collective of the mesh's; the choice is
    the argmin of the two layouts' counted collective bytes (a tie to
    ``shard``) and the layout whose gloo decode step measured fewer
    bytes; the counting mesh's trace of a decode step
    (``serve/engine.py::trace_token_step``) equals the gloo step's
    collectives, calls and bytes by kind;
  * ``moe_ep`` (``distributed/moe_ep.py``) against the port's local MoE
    and the reference's ``_moe_local``: at one token per sequence on 1x2
    and 1x4 (expert-parallel, two all-to-alls a call), the TP fallback
    (6 experts over 4 ranks, one all-reduce) and a 2x2 ``data x model``
    mesh made in the 4-rank group;
  * in this process: a 1x1 mesh is bit-equal to ``mesh=None`` for every
    stack, with zero collectives; ``moe_ep`` on one device; the engine's
    capacity bump against the reference engine's.
"""
import dataclasses
import multiprocessing as mp
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_worker as W
from _torch_parity import jax_greedy, one_torch_thread  # noqa: F401
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.launch.serve import serve_config as ref_serve_config
from repro.models import layers as jl
from repro.models import model as jm
from repro.models.config import ModelConfig as RefConfig
from repro.serve.engine import PagedEngine as RefEngine
from repro_torch import tree
from repro_torch.core.vbi.address_space import VBProps
from repro_torch.distributed.moe_ep import ep_capacity, moe_ep
from repro_torch.distributed.sharding import ParamBlocks, serve_state_specs
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import moe
from repro_torch.models.model import init_params

WORLDS = (2, 4)
#: the ranks' time limit (each world's whole run of cases)
JOIN_S = 240
#: one decode step's logits, meshed vs unmeshed, and a prompt's KV and
#: recurrent state (readings at most 2.15e-6 over every case; about 5x)
LOGIT_TOL = 1e-5
#: moe_ep against the port's and the reference's local MoE on the same
#: weights and inputs: float32 products of other shapes, summed in another
#: order (readings at most 2.4e-7; about 4x)
MOE_TOL = 1e-6
#: the reference's bound for its 2x2 moe_ep case, relative to the output's
#: largest magnitude (tests/test_distributed.py::test_moe_ep_and_decode_on_mesh)
DATA_REL_TOL = 2e-5


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
    want = jax.tree.leaves(shape)
    assert [x.shape for x in leaves] == [x.shape for x in want]
    return cfg, jax.tree.unflatten(jax.tree.structure(shape), leaves)


def _bumped(cfg):
    """``cfg`` with the engine's capacity bump on a mesh: capacity_factor
    raised to E/K."""
    return dataclasses.replace(cfg, capacity_factor=max(
        cfg.capacity_factor, cfg.n_experts / cfg.top_k))


def _moe_case(fields, key, x):
    """A hand-built MoE config (port and reference) with the reference's
    ``_init_moe`` weights: (port case, reference case)."""
    rcfg = RefConfig(**fields)
    jp = jm._init_moe(rcfg, jax.random.key(key), jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return ({"cfg": ModelConfig(**fields), "params": tp,
             "x": torch.from_numpy(x)}, (rcfg, jp, jnp.asarray(x)))


def _moe_inputs(moe_params, ref_moe_params):
    """The ``moe_ep`` cases' inputs for the ranks, and the reference's
    local MoE on each (``{case: numpy output}``)."""
    _TINY = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=4,
                 n_kv=2, head_dim=8, d_ff=0, expert_d_ff=48, vocab=64,
                 top_k=2, moe_groups=1, param_dtype="float32",
                 compute_dtype="float32")
    cfg = _bumped(tserve.serve_config("mixtral-8x7b"))
    rcfg = _bumped(ref_serve_config("mixtral-8x7b"))
    t1 = {"cfg": cfg, "params": moe_params, "x": {}}
    ref = {}
    for B, S in W.T1_SHAPES:
        x = np.random.default_rng(B).standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
        t1["x"][(B, S)] = torch.from_numpy(x)
        ref[("t1", B, S)] = np.asarray(jl.moe(ref_moe_params,
                                              jnp.asarray(x), rcfg))
    rng = np.random.default_rng(0)
    tp, (rcfg, jp, x) = _moe_case(
        dict(_TINY, n_experts=6, capacity_factor=3.0), 2,
        rng.standard_normal((2, 4, 32)).astype(np.float32))
    ref["tp"] = np.asarray(jl._moe_local(jp, x.reshape(-1, 32), rcfg)
                           ).reshape(x.shape)
    # the reference's 2x2 case (tests/test_distributed.py:60-83)
    data, (rcfg, jp, x) = _moe_case(
        dict(_TINY, n_experts=8, capacity_factor=8.0), 1,
        np.random.default_rng(0).standard_normal((4, 16, 32)
                                                 ).astype(np.float32))
    ref["data"] = np.asarray(jl._moe_local(jp, x.reshape(64, 32), rcfg)
                             ).reshape(4, 16, 32)
    return {"t1": t1, "tp": tp, "data": data}, ref


def _layer0_moe(params):
    """Layer 0's MoE weights of a layer-stacked params tree (port or
    reference)."""
    return {k: v[0] for k, v in params["stages"][0][0]["moe"].items()}


def _prompts(arch, vocab, n=2):
    """The reference's prompts (tests/test_mesh_serve.py), seeded by a
    stable hash of the arch (its ``hash(arch)`` changes per process)."""
    rng = np.random.default_rng(zlib.crc32(arch.encode()))
    return [rng.integers(0, vocab, 5).tolist() for _ in range(n)]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Compute the reference's tokens, then spawn the 1x2 and 1x4 groups
    and gather each rank's results: ``(reference, {world: [rank results]
    or the error})``.  The reference runs first: XLA's threads on every
    core beside six single-threaded ranks in lockstep collectives made
    the ranks' run two to three times as long."""
    root = tmp_path_factory.mktemp("mesh")
    inputs = {}
    for arch in W.ARCHS:
        cfg, tp = _port(arch)
        inputs[arch] = {"cfg": cfg, "params": tp,
                        "prompts": _prompts(arch, cfg.vocab)}
    ref_params = {arch: _reference_params(arch, inputs[arch]["params"])
                  for arch in W.ARCHS}
    inputs["moe"], ref_moe = _moe_inputs(
        _layer0_moe(inputs["mixtral-8x7b"]["params"]),
        _layer0_moe(ref_params["mixtral-8x7b"][1]))
    torch.save(inputs, root / "inputs.pt")
    ref = {"moe": ref_moe}
    for arch in W.ARCHS:
        cfg, jp = ref_params[arch]
        ref[arch] = {i: jax_greedy(cfg, jp, p, W.MAX_NEW)
                     for i, p in enumerate(inputs[arch]["prompts"])}
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
    return ref, results


def _ranks(spawned, world):
    res = spawned[1][world]
    if isinstance(res, str):
        pytest.fail(res)
    return res


@pytest.mark.parametrize("k", W.HORIZONS)
@pytest.mark.parametrize("layout", W.LAYOUTS)
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_tokens_match_reference(spawned, world, arch, layout, k):
    ranks = _ranks(spawned, world)
    runs = [r["tokens"][(arch, layout, k)] for r in ranks]
    assert runs[0]["out"] == spawned[0][arch], \
        f"1x{world} {arch} {layout} K={k}: tokens differ from the reference"
    for r, run in enumerate(runs[1:], 1):
        for key in ("out", "stats", "engine_stats", "free", "trace",
                    "placement"):
            assert run[key] == runs[0][key], f"rank {r} {key} differs"
    run = runs[0]
    assert run["free"][0] == run["free"][1]
    assert run["kv_layout"] == layout
    assert run["placement"] == tuple(f"cpu:{r}" for r in range(world))
    calls = {kind: c["calls"] for kind, c in run["collectives"].items()}
    assert calls["all_reduce"] > 0 and calls["all_gather"] > 0, calls
    # MoE layers dispatch expert-parallel (4 experts divide over 2 and 4)
    assert (calls["all_to_all"] > 0) == (arch in W.MOE_ARCHS), calls
    if k == 8:
        assert run["trace"], "the traced run recorded no event"


@pytest.mark.parametrize("layout", W.LAYOUTS)
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_logits_match_unmeshed_engine(spawned, world, arch, layout):
    ranks = _ranks(spawned, world)
    got = [r["logits"][(arch, layout)] for r in ranks]
    assert got[0]["err"] <= LOGIT_TOL, \
        f"1x{world} {arch} {layout}: logits off by {got[0]['err']:.3e}"
    assert got[0]["first"] == got[0]["plain_first"]
    for g in got[1:]:
        assert torch.equal(g["logits"], got[0]["logits"]), \
            "ranks sample from different logits"


@pytest.mark.parametrize("layout", W.LAYOUTS)
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_pool_leaves_are_local_shards(spawned, world, arch, layout):
    for rank in _ranks(spawned, world):
        sh = rank["shapes"][(arch, layout)]
        n_cut = 0
        for name, spec in sh["specs"].items():
            whole, local = sh["whole"][name], sh["local"][name]
            want = list(whole)
            if "model" in spec:
                d = spec.index("model")
                want[d] = whole[d] // world
                n_cut += 1
            assert tuple(want) == local, f"{name}: {local} vs {whole}"
        # every stack has a pool the shard layout cuts
        assert (n_cut > 0) == (layout == "shard")


@pytest.mark.parametrize("layout", W.LAYOUTS)
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_block_image_equals_unmeshed(spawned, world, arch, layout):
    """The unmeshed pool's image of a block (a prompt and one decoded
    token), imported into the sharded pool and exported again, is the
    same bytes and CRC; the sharded pool's own image of that block is the
    same on every rank and within the logit tolerance of the unmeshed
    one."""
    ranks = _ranks(spawned, world)
    imgs = [r["images"][(arch, layout)] for r in ranks]
    plain, back = imgs[0]["plain"], imgs[0]["round_trip"]
    assert back["checksum"] == plain["checksum"]
    for key in ("k", "v"):
        assert back[key].tobytes() == plain[key].tobytes()
    assert (back["aux"] is None) == (plain["aux"] is None)
    for a, b in zip(back["aux"] or (), plain["aux"] or ()):
        assert a.tobytes() == b.tobytes()
    own = imgs[0]["own"]
    for other in imgs[1:]:
        assert other["own"]["checksum"] == own["checksum"]
        assert other["round_trip"]["checksum"] == plain["checksum"]
    for a, b in zip([own["k"], own["v"], *(own["aux"] or ())],
                    [plain["k"], plain["v"], *(plain["aux"] or ())]):
        np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_TOL)


def test_mesh_preemption_and_swap_exactness(spawned):
    """tests/test_mesh_serve.py:128-149 on the 1x4 sharded pool: discard
    and host-swap resume equal the roomy run (the swap image gathers the
    pages across the mesh and scatters them back)."""
    for rank in _ranks(spawned, 4):
        p = rank["pressure"]
        assert p["preemptions"] >= 1 and p["swap_ins"] >= 1
        assert p["discard"] == p["roomy"] and p["swapped"] == p["roomy"]
        assert p["tier_used"] == 0
        assert p["free"] == (7, 7)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_placement_is_a_block_property(spawned, world):
    for rank in _ranks(spawned, world):
        p = rank["placement"]
        assert p["block"] == p["engine"] and len(p["block"]) == world
        assert p["sharded"]


@pytest.mark.parametrize("case,exc,item", [
    ("kernel", "ValueError", "kernel"),
    ("data", "ValueError", "kernel")])
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_refusals(spawned, world, case, exc, item):
    for rank in _ranks(spawned, world):
        got = rank["refusals"][case]
        assert got[0] == exc and item in got[1], got


def _step_bytes(step):
    return sum(c["bytes"] for c in step.values())


@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_auto_layout_picks_the_cheaper(spawned, world, arch):
    """``kv_layout='auto'`` builds on every rank with one choice: the
    argmin of the two traced layouts' collective bytes (a tie keeps
    ``shard``), the layout whose gloo decode step measured fewer bytes;
    the mesh made no collective while the engine chose."""
    ranks = _ranks(spawned, world)
    autos = [r["auto"][arch] for r in ranks]
    for a in autos:
        cand = a["report"]["candidates"]
        want = ("shard" if cand["shard"]["collective_bytes"]
                <= cand["replicate"]["collective_bytes"] else "replicate")
        assert a["kv_layout"] == a["report"]["chosen"] == want
        assert set(cand["shard"]) == {"collective_bytes",
                                      "predicted_comms_share", "flops"}
        assert all(c["calls"] == 0 and c["bytes"] == 0
                   for c in a["collectives"].values()), a["collectives"]
        assert a["kv_layout"] == autos[0]["kv_layout"]
        assert a["report"] == autos[0]["report"]
    measured = {lay: _step_bytes(ranks[0]["logits"][(arch, lay)]["step"])
                for lay in W.LAYOUTS}
    cheaper = ("shard" if measured["shard"] <= measured["replicate"]
               else "replicate")
    assert autos[0]["kv_layout"] == cheaper, (measured, autos[0]["report"])


@pytest.mark.parametrize("layout", W.LAYOUTS)
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_counting_mesh_trace_equals_gloo_step(spawned, world, arch, layout):
    """The dry run's trace of one decode token step (rank 0 of a
    ``CountingMesh`` on meta) makes the collectives, calls and bytes by
    kind, that the gloo step measured on every rank."""
    from repro_torch.launch.mesh import CountingMesh
    from repro_torch.serve.engine import pool_geometry, trace_token_step
    cfg, tp = _port(arch)
    shape = {"data": 1, "model": world}
    eng = W._engine(cfg, tp, CountingMesh(shape, device_type="cpu"), layout)
    pool = pool_geometry(eng.cfg, eng.geom, eng.n_pages, eng.page_size,
                         eng.max_seqs, eng.max_pages)
    _, mesh = trace_token_step(eng.cfg, eng.geom, shape, layout, eng.params,
                               pool, eng.max_pages)
    for r in _ranks(spawned, world):
        assert r["logits"][(arch, layout)]["step"] == mesh.collectives


def _calls(collectives):
    return {kind: c["calls"] for kind, c in collectives.items()}


@pytest.mark.parametrize("B,S", W.T1_SHAPES)
@pytest.mark.parametrize("world", WORLDS)
def test_moe_ep_T1_matches_local(spawned, world, B, S):
    """tests/test_mesh_serve.py::test_moe_ep_T1_matches_dense_bitexact on
    the port: at one token per sequence under the engine's bump, cap >=
    T_loc, and ``moe_ep`` on 1x2 and 1x4 gives the port's local ``moe``
    bit for bit at B 2 and 4 (within ``MOE_TOL`` at B 1) and the
    reference's within ``MOE_TOL``; S = 1 does not
    split over ``model``, so the tokens stay whole on every rank and a
    call makes two all-to-alls and nothing else."""
    want = spawned[0]["moe"][("t1", B, S)]
    for rank in _ranks(spawned, world):
        got = rank["moe"][("t1", B, S)]
        cap, t_loc = got["cap"]
        assert t_loc == B and cap >= t_loc, got["cap"]
        diff = float((got["ep"] - got["local"]).abs().max())
        # bit-equal where both expert products have more than one row; at
        # B = 1 the local path's one-row product takes another CPU GEMM
        # path than EP's two rows (reading 1.79e-7 on 1x2 and 1x4)
        assert diff == 0.0 if B > 1 else diff <= MOE_TOL, diff
        np.testing.assert_allclose(got["ep"].numpy(), want, rtol=0,
                                   atol=MOE_TOL)
        assert _calls(got["collectives"]) == {
            "all_reduce": 0, "all_gather": 0, "all_to_all": 2,
            "broadcast": 0,
            "reduce_scatter": 0, "ppermute": 0}
        # every rank sends its whole [E, cap, d] buffer, twice
        assert got["collectives"]["all_to_all"]["bytes"] == \
            2 * 4 * cap * 64 * 4


def test_moe_ep_tp_fallback(spawned):
    """6 experts over a 4-wide ``model`` axis: experts replicated, d_ff
    cut over ``model``, one all-reduce per call; the port's local MoE and
    the reference's within ``MOE_TOL``."""
    want = spawned[0]["moe"]["tp"]
    for rank in _ranks(spawned, 4):
        got = rank["moe"]["tp"]
        np.testing.assert_allclose(got["ep"].numpy(), got["local"].numpy(),
                                   rtol=0, atol=MOE_TOL)
        np.testing.assert_allclose(got["ep"].numpy(), want, rtol=0,
                                   atol=MOE_TOL)
        assert _calls(got["collectives"]) == {
            "all_reduce": 1, "all_gather": 0, "all_to_all": 0,
            "broadcast": 0,
            "reduce_scatter": 0, "ppermute": 0}


def test_moe_ep_on_a_data_axis(spawned):
    """The reference's 2x2 ``data x model`` case (E 8, K 2, x [4, 16,
    32]) in the 4-rank group: each rank feeds its ``data`` block and gets
    it back within the reference's 2e-5 of the largest output of the
    reference's ``_moe_local``; its tokens split over ``model`` (S 16), so
    a call makes two all-to-alls and one all-gather over ``model``."""
    want = spawned[0]["moe"]["data"]
    seen = set()
    for rank in _ranks(spawned, 4):
        got = rank["moe"]["data"]
        d = got["coords"]["data"]
        seen.add((d, got["coords"]["model"]))
        ref = want[2 * d:2 * d + 2]
        err = np.abs(got["ep"].numpy() - ref).max() / (np.abs(want).max()
                                                       + 1e-9)
        assert err < DATA_REL_TOL, err
        assert _calls(got["collectives"]) == {
            "all_reduce": 0, "all_gather": 1, "all_to_all": 2,
            "broadcast": 0,
            "reduce_scatter": 0, "ppermute": 0}
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


@pytest.mark.parametrize("topology", ("unified", "disagg"))
def test_mesh_launcher_matches_unmeshed(spawned, topology):
    """``main(['--mesh-shape', '1x2', '--kv-layout', 'shard', ...])`` in 2
    ranks gives the unmeshed launcher's tokens on every rank."""
    for rank in _ranks(spawned, 2):
        run = rank["launcher"][topology]
        assert run["mesh"] == run["plain"] and len(run["mesh"]) == 4
        # the launcher cuts the weights once, on the host: every engine
        # holds the same blocks, fewer bytes than the whole tree
        assert run["blocks"] and run["one_tree"]
        assert run["param_bytes"] < run["whole_bytes"]
        assert run["kv_layout"] == "shard"
        assert run["placement"] == ("cpu:0", "cpu:1")
        assert run["collectives"]["all_reduce"]["calls"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_helpers_broadcast_and_constrain(spawned, world):
    """``Mesh.broadcast`` from axis index 0, and ``constrain`` gathering a
    block whole and slicing it back, each collective counted."""
    for rank in _ranks(spawned, world):
        h = rank["helpers"]
        assert h["broadcast"] == [0.0, 0.0, 0.0]
        assert h["whole"] == list(map(float, range(4 * world)))
        assert h["back"]
        c = h["collectives"]
        assert (c["broadcast"]["calls"], c["all_gather"]["calls"],
                c["all_reduce"]["calls"]) == (1, 1, 0)
        assert c["broadcast"]["bytes"] == 12 and \
            c["all_gather"]["bytes"] == 16


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_ranks_never_load_jax(spawned, world):
    assert not any(r["jax_loaded"] for r in _ranks(spawned, world))


# --------------------------------------------------------------------------
# in this process: the 1x1 mesh, and the mesh's own refusals
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", W.ARCHS)
def test_mesh_1x1_bit_equal_unmeshed(arch):
    cfg, tp = _port(arch)
    prompts = _prompts(arch, cfg.vocab)
    mesh = make_host_mesh(1, 1, device="cpu")
    for k in W.HORIZONS:
        plain, _ = W._serve(W._engine(cfg, tp), prompts, W.MAX_NEW, k)
        eng = W._engine(cfg, tp, mesh, "auto")
        meshed, _ = W._serve(eng, prompts, W.MAX_NEW, k)
        assert meshed == plain
        assert eng.kv_layout == "shard" and eng.placement == ("cpu:0",)
    a, _, img_a, _ = W._step_logits(W._engine(cfg, tp), prompts)
    b, _, img_b, _ = W._step_logits(W._engine(cfg, tp, mesh, "replicate"),
                                    prompts)
    assert torch.equal(a, b) and img_a.checksum == img_b.checksum
    assert all(c["calls"] == 0 and c["bytes"] == 0
               for c in mesh.collectives.values())
    specs = serve_state_specs(eng.state, mesh, "shard")
    assert all("model" not in s for s in specs.values())
    blk = eng.alloc.alloc(0)
    assert blk.placement == ("cpu:0",) and not blk.props & VBProps.SHARDED


@pytest.mark.parametrize("arch", W.ARCHS)
def test_mesh_engine_holds_only_its_blocks(arch):
    """Given the whole params on the host, an engine on a 1x2 mesh (ranks
    built without a process group: building an engine makes no
    collective) keeps only its blocks: each leaf cut over ``model`` is
    half the whole leaf's bytes in storage of its own, so nothing of the
    whole tree stays alive through the engine; every other leaf is the
    whole one."""
    cfg, tp = _port(arch)
    whole = tree.leaves(tp)
    n_cut = 0
    for r in range(2):
        eng = W._engine(cfg, tp, Mesh(1, 2, "cpu", rank=r), "shard")
        assert isinstance(eng.params, ParamBlocks)
        for w, b in zip(whole, tree.leaves(eng.params), strict=True):
            if b.shape == w.shape:
                assert b is w
                continue
            n_cut += 1
            assert b.nbytes * 2 == w.nbytes and b.is_contiguous()
            assert b.untyped_storage().nbytes() == b.nbytes
        held = sum(t.nbytes for t in tree.leaves(eng.params))
        assert held < sum(t.nbytes for t in whole)
    assert n_cut > 0


def test_constrain_outside_a_scope_and_on_one_device():
    """No scope, or a 1-wide ``model`` axis: ``constrain`` and the
    tensor-parallel helpers return their input and count nothing."""
    from repro_torch.distributed import axes
    x = torch.arange(6.0).reshape(2, 3)
    assert axes.constrain(x, None, "model") is x
    mesh = make_host_mesh(1, 1, device="cpu")
    with axes.logical_axes(mesh):
        assert axes.constrain(x, "batch", "model") is x
        assert axes.to_whole(x, -1, 3) is x and axes.to_block(x, -1, 3) is x
        assert axes.model_sum(x) is x
        with pytest.raises(ValueError, match="names"):
            axes.constrain(x, "model")
    assert all(c["calls"] == 0 for c in mesh.collectives.values())


def test_launcher_mesh_needs_its_processes(monkeypatch, capsys):
    """``--mesh-shape 1x2`` outside ``torchrun`` (no process group, no
    ``WORLD_SIZE``) and ``--attn-impl kernel`` on it are usage errors."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for extra in ([], ["--attn-impl", "kernel"]):
        with pytest.raises(SystemExit) as e:
            tserve.main(["--device", "cpu", "--mesh-shape", "1x2"] + extra)
        assert e.value.code == 2
    err = capsys.readouterr().err
    assert "torchrun --nproc-per-node" in err and "kernel" in err


def test_host_mesh_needs_its_processes():
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        make_host_mesh(1, 2)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 256"):
        make_production_mesh()


def test_q8_refused_on_a_wide_model_axis():
    """int8 (q8) weights on a ``model`` axis wider than 1 are taken: a 1x2
    rank (built without a process group: building makes no collective)
    holds each ``q8`` leaf's ``model`` block, columns of ``wq`` and rows
    of ``wo`` and ``w2``, with the scales of its columns.  Its tokens
    equal the unmeshed int8 engine's on gloo
    (``test_torch_mesh_serve_dense.py``)."""
    from repro_torch.models.quantized import quantize_serving_params
    cfg, tp = _port("qwen3-0.6b")
    q = quantize_serving_params(tp)
    eng = W._engine(cfg, q, Mesh(1, 2, "cpu"), "shard")
    layer, whole = (eng.params["stages"][0][0], q["stages"][0][0])
    for name, dim in (("wq", -1), ("wo", -2)):
        got, want = layer["attn"][name], whole["attn"][name]
        assert got["q8"].dtype == torch.int8
        assert got["q8"].shape[dim] * 2 == want["q8"].shape[dim]
    assert layer["mlp"]["w2"]["q8"].shape[-2] * 2 == \
        whole["mlp"]["w2"]["q8"].shape[-2]
    assert layer["attn"]["wq"]["s"].shape[-1] * 2 == \
        whole["attn"]["wq"]["s"].shape[-1]


def test_moe_ep_on_one_device():
    """``moe_ep`` on a 1x1 mesh: the local dispatch in one group, no
    collective, the port's local ``moe`` bit for bit (one-token groups
    there, one group here); ``moe`` under the mesh's ``logical_axes``
    routes there, with and without ``moe_legacy_dispatch``."""
    from repro_torch.distributed.axes import logical_axes
    cfg, tp = _port("mixtral-8x7b")
    cfg, mp = _bumped(cfg), _layer0_moe(tp)
    old = dataclasses.replace(cfg, moe_legacy_dispatch=True)
    mesh = make_host_mesh(1, 1, device="cpu")
    for B, S in W.T1_SHAPES + ((2, 8),):
        x = torch.from_numpy(np.random.default_rng(B).standard_normal(
            (B, S, cfg.d_model)).astype(np.float32))
        assert ep_capacity(cfg, mesh, B, S) == (B * S, B * S)
        want = moe(mp, x, cfg)
        assert torch.equal(moe_ep(mp, x, cfg, mesh), want)
        with logical_axes(mesh, cfg.n_experts):
            assert torch.equal(moe(mp, x, cfg), want)
            assert torch.equal(moe(mp, x, old), want)
    assert all(c["calls"] == 0 for c in mesh.collectives.values())


@pytest.mark.parametrize("arch", W.MOE_ARCHS)
def test_mesh_engine_capacity_bump(arch):
    """On any mesh, 1x1 included, the engine raises capacity_factor to
    E/K before it builds anything, as the reference engine does, and
    serves with it: the 1x1 engine's tokens equal the reference's greedy
    decode; without a mesh the config is left as it is."""
    cfg, tp = _port(arch)
    rcfg, jp = _reference_params(arch, tp)
    want = max(cfg.capacity_factor, cfg.n_experts / cfg.top_k)
    assert want > cfg.capacity_factor
    mesh = make_host_mesh(1, 1, device="cpu")
    eng = W._engine(cfg, tp, mesh)
    ref = RefEngine(rcfg, jp, n_pages=9, page_size=8, max_seqs=1,
                    mesh=ref_host_mesh(1, 1), kv_layout="shard")
    assert eng.cfg.capacity_factor == ref.cfg.capacity_factor == want
    assert W._engine(cfg, tp).cfg.capacity_factor == cfg.capacity_factor
    cap, t_loc = ep_capacity(eng.cfg, mesh, eng.max_seqs, 1)
    assert cap >= t_loc == eng.max_seqs
    prompts = _prompts(arch, cfg.vocab)
    out, _ = W._serve(eng, prompts, W.MAX_NEW, 8)
    assert out == {i: jax_greedy(rcfg, jp, p, W.MAX_NEW)
                   for i, p in enumerate(prompts)}
