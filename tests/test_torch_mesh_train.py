"""Training on a device mesh in the port (the SPMD train step, state and
batch specs, gradient compression, ``pipeline_apply``, elastic restore,
the production mesh) against the reference's single-device step.

The reference's sharded-step test (``tests/test_distributed.py:23``)
holds a 2x4 GSPMD step against the single-device jitted step; GSPMD does
not run on this jax (ROADMAP.md § C2), so the port's SPMD step is held
against the reference's single-device step directly, computed here
before the ranks start.  The ranks run as the port runs them: one
process per mesh device, one gloo group of 4 spawned for the module
(``_torch_mesh_train_worker.run``, which imports no JAX; a file
rendezvous, every collective bounded by 60 s, the parent kills ranks
still alive after ``JOIN_S`` and fails their tests).  Each case builds
its own mesh over the group: 2x2, 1x4 and 4x1 ``data x model``, a
4-wide ``pod`` and a 4-stage ``pipe`` axis.

Tolerances, each with its reason:
  * the reference's dense config (2 layers, d 64, 4/2 heads, d_ff 128,
    vocab 256, float32 params) at float32 compute, on every mesh, accum 1
    and 2, remat off and on: loss and params within 1e-4 (the reference
    test's bounds), and — since one Adam step moves each param by about
    lr whatever its gradient — the grad norm within 1e-5 relative and
    each m and v leaf within 1e-5 of its norm.  Readings: loss at most
    9.5e-7, grad norm 0 (equal float32 values), params 1.5e-7, m and v
    1.5e-6 (gemma3 below: 2.2e-6).  A leaf's
    gradient off by the ``model`` or ``data`` width moves its m by 100%;
    a replicated leaf not summed over ``data`` moves it by 50% or more;
  * the same config at its own bfloat16 compute (the reference test's
    exact config) on 2x2: loss and params 1e-4, grad norm 1e-4 and m, v
    2e-2 (readings 1.4e-5, 2.0e-5, 3.1e-5 and 7.9e-3) — the bounds
    ``test_torch_train.py`` gives one device at
    bfloat16 compute: each rank's bfloat16 products of its batch block
    round apart from one product over the whole batch (the lm_head
    gradient, summed in bfloat16 over 64 positions instead of 256, moves
    by 2e-3 of its norm);
  * qwen3 (qk-norm, tied embeddings) and gemma3 (local and global
    layers) smoke stacks at float32 compute on 2x2: the dense bounds;
  * ``bf16_params_in_compute`` at float32 compute on 2x2 (each rank
    casts its blocks, the FSDP gathers move bfloat16): the bfloat16
    bounds above (readings 9.5e-7, 1.0e-5, 2.5e-5 and 6.3e-3): the
    gradient of a bfloat16 weight is rounded to bfloat16 on each rank
    before the ranks' shares are summed, where one device rounds the
    whole batch's once;
  * a step with the EF compressor, meshed and not, against the
    reference's ``make_train_step(compress=)``: loss and params 1e-4 (the
    int8 codes of an element a rounding from a code boundary may differ,
    which moves that element of m by a code step, so m and v are not
    held; the params bound holds, lr being 1e-5 at step 1);
  * ``compressed_psum`` equals the reference's formula on the reference's
    ``quantize_leaf`` exactly (the same int8 codes, an exact int32 sum);
  * ``pipeline_apply`` within 1e-5 of the sequential product (the
    reference test's bound);
  * elastic restore and the 1x1 mesh: array-equal and bit-equal.
"""
import dataclasses
import multiprocessing as mp
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import _torch_mesh_train_worker as W
from _torch_parity import one_torch_thread  # noqa: F401
from repro.checkpoint import restore_pytree as ref_restore
from repro.configs import smoke_config as ref_smoke_config
from repro.data.pipeline import SyntheticLMData as RefData
from repro.distributed import compression as jc
from repro.distributed import sharding as js
from repro.models import model as jm
from repro.models.config import ModelConfig as RefConfig
from repro.optim.adamw import AdamWConfig as RefAdamW
from repro.train import step as jstep
from repro_torch import tree
from repro_torch.configs import smoke_config
from repro_torch.distributed import compression as tc
from repro_torch.distributed import sharding as ts
from repro_torch.distributed.axes import logical_axes
from repro_torch.launch import train as launch_train
from repro_torch.launch.dryrun import trace_train_step
from repro_torch.launch.mesh import (CountingMesh, Mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.specs import batch_specs
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import params_from_numpy, params_shape
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.train.step import abstract_train_state, make_train_step

#: the ranks' time limit (all cases in one group)
JOIN_S = 240
#: tests/test_distributed.py:33-35
DENSE = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv=2, head_dim=16, d_ff=128, vocab=256, remat=False,
             param_dtype="float32")
LOSS_TOL = PARAM_TOL = 1e-4
GNORM_RTOL = MOMENT_RTOL = 1e-5
BF16_GNORM_RTOL, BF16_MOMENT_RTOL = 1e-4, 2e-2
PIPE_TOL = 1e-5
#: the dense config's leaves per layer that FSDP cuts (wq wk wv wo w1 w3
#: w2) and its leaves not cut over ``data`` (embed, final_norm, lm_head,
#: ln1, ln2): their gradients take one all-reduce each
F_LEAVES, R_LEAVES = 7, 5


def expected_collectives(D, M, L, accum, remat, F=F_LEAVES, R=R_LEAVES):
    """Collective calls of one SPMD train step on a ``D x M`` mesh (PERF.md
    § 3, train mesh): with a wide ``model`` axis, per microbatch, the
    embedding's from_model, per layer the from_models of wo and w2 and
    the to_model backwards of the q/k/v and w1/w3 inputs (4 L), the
    logits' to_model backward; remat replays each layer's attention
    from_model (the MLP's, after the last saved tensor, is cut by the
    replay's early stop).  With a wide ``data`` axis, per microbatch, F
    FSDP gathers a layer (again under remat) and F reduce-scatters
    backward; once a step R all-reduces of the leaves FSDP does not cut
    and the loss's.  On a ``model`` axis, per microbatch, per layer the
    q/k/v gather and wo's split backward, remat's q/k/v gather, and the
    logits' gather.  One all-reduce of the grad norm."""
    d, m = D > 1, M > 1
    return {
        "all_reduce": accum * m * (4 * L + 2 + remat * L)
        + d * (R + 1) + 1,
        "all_gather": accum * (d * F * L * (1 + remat)
                               + m * (L * (2 + remat) + 1)),
        "reduce_scatter": accum * d * F * L,
        "all_to_all": 0, "broadcast": 0, "ppermute": 0}


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _port_cfg(ref_cfg):
    return ModelConfig(**{f.name: getattr(ref_cfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _case(ref_cfg, lr=1e-3):
    """A case for the ranks and the reference's single-device step on it:
    (case, reference result)."""
    opt = RefAdamW(lr=lr)
    batch = RefData(ref_cfg, 8, 32, 0).batch_at(0)
    state = jstep.init_train_state(ref_cfg, opt, jax.random.key(0))
    params = _np(state["params"])
    s_ref, m_ref = jax.jit(jstep.make_train_step(ref_cfg, opt))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    case = {"cfg": _port_cfg(ref_cfg), "opt": AdamWConfig(lr=lr),
            "params": params, "batch": batch}
    return case, {"metrics": {k: float(v) for k, v in m_ref.items()},
                  "state": _np(s_ref)}


def _ref_compressed(ref_cfg, lr=1e-3):
    """The reference's step with its EF compressor as the ``compress``
    hook, from a zero error-feedback state (one step: the hook's state
    starts at zero inside the jitted step)."""
    opt = RefAdamW(lr=lr)
    compress, _ = jc.make_ef_compressor()

    def hook(grads):
        zeros = jax.tree.map(lambda g: jnp.zeros(g.shape, jnp.float32),
                             grads)
        return compress(grads, zeros)[0]

    batch = RefData(ref_cfg, 8, 32, 0).batch_at(0)
    state = jstep.init_train_state(ref_cfg, opt, jax.random.key(0))
    s, m = jax.jit(jstep.make_train_step(ref_cfg, opt, compress=hook))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"metrics": {k: float(v) for k, v in m.items()},
            "state": _np(s)}


def _ref_psum(xs):
    """The reference's ``compressed_psum`` formula over the rows of ``xs``
    (one per rank), on its ``quantize_leaf``."""
    scale = max(float(jc.quantize_leaf(jnp.asarray(x))[1]) for x in xs)
    s = jnp.float32(scale)
    acc = sum(np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / s), -127, 127)
                         .astype(jnp.int8)).astype(np.int32) for x in xs)
    return np.asarray(jnp.asarray(acc).astype(jnp.float32) * s)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The reference's steps first, then the 4-rank group: ``(reference,
    [rank results] or the error)``."""
    root = tmp_path_factory.mktemp("mesh_train")
    f32 = RefConfig(**DENSE, compute_dtype="float32")
    inputs, ref = {}, {"matrix": {}}
    for accum in W.ACCUMS:
        case, r = _case(dataclasses.replace(f32, grad_accum=accum))
        inputs.setdefault("dense", case)
        ref["matrix"][accum] = r
    inputs["dense"]["cfg"] = _port_cfg(f32)
    for name in W.EXTRA:
        rc = {"bf16": RefConfig(**DENSE),
              "bf16_params": dataclasses.replace(
                  f32, bf16_params_in_compute=True)}.get(name) or \
            dataclasses.replace(ref_smoke_config(name),
                                compute_dtype="float32")
        inputs[name], ref[name] = _case(rc)
    ref["compressed"] = _ref_compressed(f32)
    rng = np.random.default_rng(0)
    inputs["psum_x"] = (rng.standard_normal((W.WORLD, 64)) * 0.01
                        ).astype(np.float32)
    ref["psum"] = _ref_psum(inputs["psum_x"])
    # tests/test_distributed.py:117-140
    inputs["pipe_w"] = (rng.standard_normal((W.WORLD, 16, 16)) * 0.3
                        ).astype(np.float32)
    inputs["pipe_x"] = rng.standard_normal((6, 8, 16)).astype(np.float32)
    h = jnp.asarray(inputs["pipe_x"])
    for i in range(W.WORLD):
        h = jnp.tanh(h @ jnp.asarray(inputs["pipe_w"][i]))
    ref["pipe"] = np.asarray(h)
    torch.save(inputs, root / "inputs.pt")
    ckpt = root / "ckpt"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.run, args=(
        r, W.WORLD, str(root / "rdzv"), str(root / "inputs.pt"), str(root),
        str(ckpt)), daemon=True) for r in range(W.WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errs = [f"rank {r}:\n{(root / f'rank{r}.err').read_text()}"
            for r in range(W.WORLD) if (root / f"rank{r}.err").exists()]
    if hung or errs or any(p.exitcode for p in procs):
        return ref, (f"hung {hung} (killed after {JOIN_S} s), exit codes "
                     f"{[p.exitcode for p in procs]}\n" + "\n".join(errs))
    return ref, [torch.load(root / f"rank{r}.pt", weights_only=False)
                 for r in range(W.WORLD)] + [ckpt]


def _ranks(spawned):
    res = spawned[1]
    if isinstance(res, str):
        pytest.fail(res)
    return res[:W.WORLD]


def _rel(a, b):
    return abs(a - b) / abs(b)


def _check_step(got, want, gnorm_rtol=GNORM_RTOL, moment_rtol=MOMENT_RTOL):
    """A rank-0 result (metrics, whole state) against the reference's."""
    gm, wm = got["metrics"], want["metrics"]
    assert abs(gm["loss"] - wm["loss"]) < LOSS_TOL, (gm, wm)
    assert _rel(gm["grad_norm"], wm["grad_norm"]) < gnorm_rtol, (gm, wm)
    assert gm["lr"] == pytest.approx(wm["lr"], rel=1e-7)
    s, r = got["state"], want["state"]
    for a, b in zip(tree.leaves(s["params"]),
                    jax.tree.leaves(r["params"]), strict=True):
        assert a.shape == b.shape
        assert np.abs(a.numpy() - b).max() < PARAM_TOL
    for k in ("m", "v"):
        for a, b in zip(tree.leaves(s["opt"][k]),
                        jax.tree.leaves(r["opt"][k]), strict=True):
            err = np.linalg.norm(a.numpy() - b) / np.linalg.norm(b)
            assert err < moment_rtol, (k, err)
    assert int(s["opt"]["step"]) == int(r["opt"]["step"]) == 1


def _same_metrics(ranks, get):
    ms = [get(r)["metrics"] for r in ranks]
    assert all(m == ms[0] for m in ms), ms


@pytest.mark.parametrize("remat", W.REMATS)
@pytest.mark.parametrize("accum", W.ACCUMS)
@pytest.mark.parametrize("shape", W.SHAPES)
def test_sharded_step_matches_reference(spawned, shape, accum, remat):
    ranks = _ranks(spawned)
    _check_step(ranks[0]["matrix"][(shape, accum, remat)],
                spawned[0]["matrix"][accum])
    _same_metrics(ranks, lambda r: r["matrix"][(shape, accum, remat)])


@pytest.mark.parametrize("remat", W.REMATS)
@pytest.mark.parametrize("accum", W.ACCUMS)
@pytest.mark.parametrize("shape", W.SHAPES)
def test_collective_counts_match_formula(spawned, shape, accum, remat):
    want = expected_collectives(*shape, DENSE["n_layers"], accum, remat)
    for rank in _ranks(spawned):
        got = rank["matrix"][(shape, accum, remat)]["collectives"]
        assert {k: c["calls"] for k, c in got.items()} == want


@pytest.mark.parametrize("remat", W.REMATS)
@pytest.mark.parametrize("accum", W.ACCUMS)
@pytest.mark.parametrize("shape", W.SHAPES)
def test_counting_mesh_trace_equals_gloo_step(spawned, shape, accum, remat):
    """The dry run's trace of the step (rank 0 of a ``CountingMesh`` on
    meta, ``launch/dryrun.py::trace_train_step``) makes the collectives,
    calls and bytes by kind, that the gloo step measured on every
    rank."""
    cfg = ModelConfig(**DENSE, compute_dtype="float32", grad_accum=accum)
    cfg = dataclasses.replace(cfg, remat=remat)
    opt = AdamWConfig(lr=1e-3)
    mesh = CountingMesh({"data": shape[0], "model": shape[1]})
    trace_train_step(cfg, opt, mesh, abstract_train_state(cfg, opt),
                     batch_specs(cfg, 8, 32))
    for rank in _ranks(spawned):
        got = rank["matrix"][(shape, accum, remat)]["collectives"]
        assert got == mesh.collectives


@pytest.mark.parametrize("name", W.EXTRA)
def test_other_stacks_match_reference_on_2x2(spawned, name):
    ranks = _ranks(spawned)
    tols = ((BF16_GNORM_RTOL, BF16_MOMENT_RTOL)
            if name in ("bf16", "bf16_params") else (GNORM_RTOL, MOMENT_RTOL))
    _check_step(ranks[0]["extra"][name], spawned[0][name], *tols)
    _same_metrics(ranks, lambda r: r["extra"][name])


def _state_shape(cfg):
    """The train state of ``cfg`` as ``meta`` tensors."""
    params = params_shape(cfg)
    return {"params": params, "opt": {"m": params, "v": params,
                                      "step": torch.empty((), device="meta")}}


def _specs(cfg, mesh):
    """``[(leaf key, spec)]`` of ``cfg``'s train state on ``mesh``."""
    return [(k, tuple(sh.spec)) for k, sh in tree.leaves_with_path(
        ts.shardings_of(ts.state_specs(cfg, _state_shape(cfg), mesh),
                        mesh))]


def _specs_2x2():
    """{leaf key: spec} of the dense config's train state on 2x2."""
    return dict(_specs(_port_cfg(RefConfig(**DENSE)), Mesh(2, 2, "cpu")))


@pytest.mark.parametrize("i", range(len(W.POD_CASES)))
def test_pod_meshes_match_reference(spawned, i):
    """A ``pod`` axis: FSDP over ``("pod", "data")`` together
    (``fsdp_axes="pod_data"``: gathers and reduce-scatters over the pair's
    group), over ``data`` with the leaves replicated over ``pod`` (their
    gradients summed over ``pod`` by all-reduce), and the batch over
    ``pod`` beside a ``model`` axis; the dense bounds."""
    ranks = _ranks(spawned)
    _check_step(ranks[0]["pod"][i], spawned[0]["matrix"][1])
    _same_metrics(ranks, lambda r: r["pod"][i])
    axes, fsdp = W.POD_CASES[i]
    calls = {k: c["calls"] for k, c in
             ranks[0]["pod"][i]["collectives"].items()}
    fsdp_wide = (axes.get("data", 1) > 1
                 or (fsdp == "pod_data" and axes.get("pod", 1) > 1))
    assert (calls["reduce_scatter"] > 0) == fsdp_wide
    assert calls["all_reduce"] > 0


def test_replicated_leaves_bit_identical_across_ranks(spawned):
    """After two steps every rank holding the same block of a leaf holds
    the same bits: leaves replicated over ``data`` (their gradients summed
    by all-reduce), over ``model`` (equal by construction) or both."""
    ranks = _ranks(spawned)
    specs = _specs_2x2()
    shared = 0
    for key, spec in specs.items():
        cut = {a for ax in spec if ax is not None
               for a in (ax if isinstance(ax, tuple) else (ax,))}
        held = {}
        for rank in ranks:
            c = rank["replicated"]["coords"]
            blk = dict(rank["replicated"]["leaves"])[key]
            held.setdefault(tuple(c[a] for a in sorted(cut)), []).append(blk)
        for blocks in held.values():
            assert all(torch.equal(b, blocks[0]) for b in blocks), key
        shared += len(cut) < 2
    # embed, final_norm, lm_head, ln1, ln2 in params, m and v, and step
    assert shared == 3 * R_LEAVES + 1
    _same_metrics(ranks, lambda r: r["replicated"])


def test_compressed_psum_matches_reference_formula(spawned):
    for rank in _ranks(spawned):
        np.testing.assert_array_equal(rank["compressed"]["psum"].numpy(),
                                      spawned[0]["psum"])
        calls = {k: c["calls"] for k, c in
                 rank["compressed"]["psum_collectives"].items()}
        assert calls["all_reduce"] == 2                  # max, int32 sum
        assert rank["compressed"]["psum_collectives"]["all_reduce"][
            "bytes"] == 4 + 64 * 4


def test_ef_compressed_step_on_2x2_matches_reference(spawned):
    ranks = _ranks(spawned)
    got, want = ranks[0]["compressed"], spawned[0]["compressed"]
    assert abs(got["metrics"]["loss"] - want["metrics"]["loss"]) < LOSS_TOL
    for a, b in zip(tree.leaves(got["state"]["params"]),
                    jax.tree.leaves(want["state"]["params"]), strict=True):
        assert np.abs(a.numpy() - b).max() < PARAM_TOL
    _same_metrics(ranks, lambda r: r["compressed"])


def test_pipeline_matches_sequential(spawned):
    for rank in _ranks(spawned):
        p = rank["pipeline"]
        np.testing.assert_allclose(p["out"].numpy(), spawned[0]["pipe"],
                                   atol=PIPE_TOL, rtol=PIPE_TOL)
        assert p["held"] == (1, 16, 16)               # its stage only
        c = p["collectives"]
        assert c["ppermute"]["calls"] == 6 + W.WORLD - 1
        assert c["broadcast"]["calls"] == 1


def test_elastic_restore_across_meshes(spawned):
    """A 2x2 save restores onto 1x4, 4x1, 2x2 and no mesh array-equal,
    and the reference's ``restore_pytree`` reads it."""
    ranks = _ranks(spawned)
    ckpt = spawned[1][W.WORLD]
    saved = ranks[0]["elastic"]["saved"]
    for rank in ranks:
        for shape, got in rank["elastic"]["restored"].items():
            for a, b in zip(tree.leaves(got), tree.leaves(saved),
                            strict=True):
                assert torch.equal(a, b), shape
    params = params_from_numpy(_np(jm.init_params(
        RefConfig(**DENSE), jax.random.key(0))), device="cpu")
    template = {"params": params, "opt": init_opt_state(params,
                                                        AdamWConfig())}
    from repro_torch.checkpoint import restore_pytree
    plain = restore_pytree(template, ckpt, 1)
    for a, b in zip(tree.leaves(plain), tree.leaves(saved), strict=True):
        assert torch.equal(a, b)
    ref_template = jstep.init_train_state(RefConfig(**DENSE),
                                          RefAdamW(), jax.random.key(0))
    theirs = ref_restore(ref_template, str(ckpt), 1)
    for a, b in zip(jax.tree.leaves(theirs), tree.leaves(saved),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_loop_agrees_on_a_preemption_and_saves_together(spawned):
    """A preemption notice on one rank of 2x2: every rank's loop stops
    after the same step and saves it (the save gathers every leaf, a
    collective: had rank 1 saved alone, the group would have hung), and
    every rank sees the step on disk."""
    got = [r["loop"] for r in _ranks(spawned)]
    assert all(g == got[0] for g in got), got
    assert got[0]["end"] == 1 and got[0]["latest"] == 1
    assert len(got[0]["losses"]) == 1


def test_mesh_train_ranks_never_load_jax(spawned):
    assert not any(r["jax_loaded"] for r in _ranks(spawned))


# --------------------------------------------------------------------------
# in this process
# --------------------------------------------------------------------------
def _port_case(remat=True):
    """The dense config at float32 compute: (cfg, opt, state with the
    reference's params, batch)."""
    rcfg = RefConfig(**dict(DENSE, remat=remat), compute_dtype="float32")
    cfg = _port_cfg(rcfg)
    params = params_from_numpy(_np(jm.init_params(rcfg, jax.random.key(0))),
                               device="cpu")
    opt = AdamWConfig(lr=1e-3)
    batch = {k: torch.from_numpy(v) for k, v in
             RefData(cfg, 8, 32, 0).batch_at(0).items()}
    return cfg, opt, {"params": params,
                      "opt": init_opt_state(params, opt)}, batch


def test_mesh_1x1_step_bit_equal_unmeshed(monkeypatch):
    """On a 1x1 mesh the step takes its SPMD branch (batch block, loss
    over the batch ranks, the sharded norm) and is bit-equal to the
    unmeshed step."""
    from repro_torch.train import step as step_mod
    entered = []

    def spmd_train(mesh, **kw):
        entered.append(mesh)
        return spmd_train_orig(mesh, **kw)
    spmd_train_orig = step_mod.spmd_train
    monkeypatch.setattr(step_mod, "spmd_train", spmd_train)
    cfg, opt, state, batch = _port_case()
    plain = tree.tree_map(torch.clone, state)
    mesh = make_host_mesh(1, 1, device="cpu")
    sh = ts.shard_state(cfg, state, mesh, "cpu")
    assert all(a is b for a, b in zip(tree.leaves(sh), tree.leaves(state)))
    step = make_train_step(cfg, opt)
    for i in range(2):
        plain, m_plain = step(plain, batch)
        assert len(entered) == i
        with logical_axes(mesh):
            sh, m_mesh = step(sh, batch)
        assert entered == [mesh] * (i + 1)
        assert all(torch.equal(m_plain[k], m_mesh[k]) for k in m_plain)
    for a, b in zip(tree.leaves(plain), tree.leaves(sh), strict=True):
        assert torch.equal(a, b)
    assert all(c["calls"] == 0 for c in mesh.collectives.values())


@pytest.mark.parametrize("multi_pod,n", [(False, 256), (True, 512)])
def test_production_mesh_needs_its_world(monkeypatch, tmp_path, multi_pod,
                                         n):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match=f"{n} processes"):
        make_production_mesh(multi_pod=multi_pod)
    flag = "multipod" if multi_pod else "pod"
    with pytest.raises(RuntimeError, match=f"needs {n} processes"):
        launch_train.main(["--smoke", "--device", "cpu", "--mesh", flag,
                           "--ckpt-dir", str(tmp_path)])
    monkeypatch.setenv("WORLD_SIZE", "8")
    with pytest.raises(RuntimeError, match=f"needs {n} processes.*has 8"):
        launch_train.main(["--smoke", "--device", "cpu", "--mesh", flag,
                           "--ckpt-dir", str(tmp_path)])


POD_MESHES = (((2, 2), ("data", "model")), ((2, 4), ("data", "model")),
              ((2, 2, 2), ("pod", "data", "model")),
              ((2, 16, 16), ("pod", "data", "model")))


def _port_mesh(shape, names):
    return Mesh(axes=dict(zip(names, shape)))


@pytest.mark.parametrize("fsdp", ("data", "pod_data"))
@pytest.mark.parametrize("shape,names", POD_MESHES)
@pytest.mark.parametrize("arch", ("qwen3-0.6b", "gemma3-12b"))
def test_state_and_batch_specs_match_reference(arch, shape, names, fsdp):
    """``state_specs`` and ``batch_spec`` leaf by leaf against the
    reference's on an ``AbstractMesh`` of the same shape (pod meshes and
    ``fsdp_axes`` included; a dim that does not divide drops its axis)."""
    rcfg = dataclasses.replace(ref_smoke_config(arch), fsdp_axes=fsdp)
    cfg = dataclasses.replace(smoke_config(arch), fsdp_axes=fsdp)
    st = jstep.abstract_train_state(rcfg, RefAdamW())
    rmesh = AbstractMesh(shape, names)
    mesh = _port_mesh(shape, names)
    want = jax.tree_util.tree_flatten_with_path(
        js.state_specs(rcfg, st, rmesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    assert [(jax.tree_util.keystr(p), tuple(s)) for p, s in want] == \
        _specs(cfg, mesh)
    for B in (8, 6, 1):
        batch = {"tokens": np.zeros((B, 16), np.int32),
                 "labels": np.zeros((B, 16), np.int32),
                 "step": np.zeros((), np.int32)}
        w = js.batch_spec(rcfg, batch, rmesh)
        g = ts.batch_spec(cfg, batch, mesh)
        assert {k: tuple(v) for k, v in w.items()} == \
            {k: tuple(v) for k, v in g.items()}


def test_shard_state_cuts_fresh_blocks():
    """Each rank's blocks of ``shard_state`` on 2x2 are its ``Sharding``'s
    blocks of the whole leaves, in fresh storage where cut: wq is cut over
    both axes (d over ``data``, heads over ``model``)."""
    cfg, _, state, _ = _port_case()
    shapes = {}
    for r in range(4):
        mesh = Mesh(2, 2, "cpu", rank=r)
        sh = ts.shardings_of(ts.state_specs(cfg, state, mesh), mesh)
        blocks = ts.shard_state(cfg, state, mesh, "cpu")
        for (k, b), w, s in zip(tree.leaves_with_path(blocks),
                                tree.leaves(state), tree.leaves(sh)):
            assert torch.equal(s.local(w), b), k
            if b.shape != w.shape:
                assert b.untyped_storage().data_ptr() != \
                    w.untyped_storage().data_ptr() and b.is_contiguous()
            shapes.setdefault(k, b.shape)
    wq = shapes["['params']['stages'][0][0]['attn']['wq']"]
    assert tuple(wq) == (2, 32, 32)                  # d over data, H over model


def test_ef_compressor_matches_reference():
    """``quantize_leaf``, ``dequantize_leaf`` and ``make_ef_compressor``
    array-equal to the reference's on the same inputs (tiny, typical and
    zero gradients, three steps of error feedback)."""
    rng = np.random.default_rng(1)
    for scale in (1e-20, 0.01, 1.0, 0.0):
        g = (rng.standard_normal((37, 29)) * scale).astype(np.float32)
        qj, sj = jc.quantize_leaf(jnp.asarray(g))
        qt, st = tc.quantize_leaf(torch.from_numpy(g))
        assert qt.dtype == torch.int8
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert st.item() == float(sj)
        np.testing.assert_array_equal(tc.dequantize_leaf(qt, st).numpy(),
                                      np.asarray(jc.dequantize_leaf(qj, sj)))
    grads = {"w": (rng.standard_normal(100) * 0.01).astype(np.float32),
             "b": [(rng.standard_normal(5)).astype(np.float32)]}
    cj, ij = jc.make_ef_compressor()
    ct, it = tc.make_ef_compressor()
    ej = ij(jax.tree.map(jnp.asarray, grads))
    et = it(params_from_numpy(grads, device="cpu"))
    for _ in range(3):
        dj, ej = cj(jax.tree.map(jnp.asarray, grads), ej)
        dt, et = ct(params_from_numpy(grads, device="cpu"), et)
        for a, b in zip(tree.leaves(dt) + tree.leaves(et),
                        jax.tree.leaves(dj) + jax.tree.leaves(ej)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_ef_compressed_step_matches_reference():
    """The unmeshed port step with the EF compressor as its ``compress``
    hook against the reference's (loss and params: the module doc)."""
    rcfg = RefConfig(**DENSE, compute_dtype="float32")
    want = _ref_compressed(rcfg)
    cfg, opt, state, batch = _port_case(remat=False)
    compress, init = tc.make_ef_compressor()
    ef = {}

    def hook(grads):
        if "ef" not in ef:
            ef["ef"] = init(grads)
        deq, ef["ef"] = compress(grads, ef["ef"])
        return deq

    state, m = make_train_step(cfg, opt, compress=hook)(state, batch)
    assert abs(float(m["loss"]) - want["metrics"]["loss"]) < LOSS_TOL
    for a, b in zip(tree.leaves(state["params"]),
                    jax.tree.leaves(want["state"]["params"]), strict=True):
        assert np.abs(a.numpy() - b).max() < PARAM_TOL

