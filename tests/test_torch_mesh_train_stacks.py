"""Every remaining stack on a training mesh in the port: MoE (EP, the TP
fallback, tokens that do not split over ``model``, a batch the batch
ranks do not divide, ``pod x data``), RG-LRU (also with ``rnn_width`` !=
``d_model``), Mamba-2, encoder-decoder and vision stacks, each through
the SPMD train step against the reference's single-device step.

As in ``test_torch_mesh_train.py`` (whose pattern this file follows), the
reference's jitted single-device steps are computed here before the
ranks start; one gloo group of 4 is spawned for the module
(``_torch_mesh_train_stacks_worker.run``, which imports no JAX; a file
rendezvous, every collective bounded by 60 s, the parent kills ranks
still alive after ``JOIN_S`` and fails their tests), and each case builds
its own mesh over it.

Tolerances, each with its reason:
  * every stack at float32 compute takes the dense bounds of
    ``test_torch_mesh_train.py``: loss and params within 1e-4, the grad
    norm within 1e-5 relative, each m and v leaf within 1e-5 of its norm.
    The MoE cases need no looser bound, and their configs set
    ``capacity_factor`` to E/K on both sides: the meshed step dispatches
    through ``moe_ep`` with one capacity per local block, the reference's
    unmeshed step through its local path with one per group, and below
    E/K the two drop different (token, expert) pairs.  No MoE comparison
    is bit-equal: a token's expert row sits in GEMMs of other row counts,
    and its K outputs are summed in the port's fixed order where the
    reference scatter-adds;
  * the MoE forwards with drops (the smoke config's own
    ``capacity_factor`` 1.25): each rank's ``moe_ep`` output within 1e-5
    of the reference's ``_local_dispatch``, expert FFN and
    ``_local_combine`` on that rank's token block (float32; the TP
    fallback sums partial products of ``d_ff`` blocks), and the blocks
    drop pairs;
  * collective calls equal :func:`expected_collectives` (PERF.md § 6),
    all-to-alls and remat replays included;
  * on a 1x1 mesh (in this process) the dense-MLP stacks are bit-equal to
    the unmeshed step and the MoE within the dense bounds.
"""
import dataclasses
import multiprocessing as mp
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import _torch_mesh_train_stacks_worker as W
from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs import smoke_config as ref_smoke_config
from repro.data.pipeline import SyntheticLMData as RefData
from repro.distributed import moe_ep as ref_ep
from repro.models import model as jm
from repro.train import step as jstep
from repro.optim.adamw import AdamWConfig as RefAdamW
from repro_torch import tree
from repro_torch.distributed import sharding as ts
from repro_torch.distributed.axes import logical_axes
from repro_torch.launch.dryrun import trace_train_step
from repro_torch.launch.mesh import CountingMesh, Mesh, make_host_mesh
from repro_torch.launch.specs import batch_specs
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import params_from_numpy, params_shape
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.train.step import abstract_train_state, make_train_step

#: the ranks' time limit (all cases in one group)
JOIN_S = 240
LOSS_TOL = PARAM_TOL = 1e-4
GNORM_RTOL = MOMENT_RTOL = 1e-5
DROP_TOL = 1e-5
#: the drop forwards' input: batch 4, 16 tokens
DROP_SHAPE = (4, 16)

#: per part of a layer, the collective calls it makes on a ``model`` axis
#: wider than 1 in one forward and backward, ``(all_reduce, all_gather,
#: all_to_all)``: forward, backward, and the forward's collectives after
#: the part's last saved tensor (which a remat replay of a layer ending in
#: the part skips)
PARTS = {
    # q/k/v gather; wo's from_model | to_model of x; wo's split_model
    "attn": ((1, 1, 0), (1, 1, 0), (1, 0, 0)),
    # cross-attention: q gather, k/v gather, wo's from_model | to_model of
    # x and of the encoder output; wo's split_model
    "xattn": ((1, 2, 0), (2, 1, 0), (1, 0, 0)),
    # branches gather, gate gather, out's from_model | to_model of x and
    # of the conv output; out's split_model
    "rglru": ((1, 2, 0), (2, 1, 0), (1, 0, 0)),
    # in_proj gather, conv_w gather, out_proj's from_model | to_model of
    # x; out_proj's split_model
    "mamba": ((1, 2, 0), (1, 1, 0), (1, 0, 0)),
    # w2's from_model | to_model of x
    "mlp": ((1, 0, 0), (1, 0, 0), (1, 0, 0)),
    # EP over a token slice: two exchanges, the tokens' gather_model |
    # two exchanges, the tokens' split_model, the router's to_model
    "moe_ep": ((0, 1, 2), (1, 1, 2), (0, 1, 0)),
    # EP over tokens whole on every rank: the outputs' gather_model | the
    # buffer's split_model
    "moe_ep_whole": ((0, 1, 0), (0, 1, 0), (0, 0, 0)),
    # TP fallback: from_model | the buffer's to_model
    "moe_tp": ((1, 0, 0), (1, 0, 0), (0, 0, 0)),
    # the local path on a batch left whole: w1, w3, w2 gathered whole
    "moe_local": ((0, 3, 0), (0, 0, 0), (0, 0, 0)),
}
_KINDS = ("all_reduce", "all_gather", "all_to_all")


def _layer_parts(cfg, kind, moe_part):
    """The parts of one decoder layer of ``kind``, in order."""
    mixer = {"mamba": ["mamba"], "rglru": ["rglru"]}.get(kind, ["attn"])
    if kind == "mamba":
        return mixer
    cross = ["xattn"] if cfg.is_encdec else []
    return mixer + cross + [moe_part if kind == "moe" else "mlp"]


def _moe_part(cfg, axes, S, batch_cut):
    n_m = axes.get("model", 1)
    if not batch_cut:
        return "moe_local"
    if cfg.n_experts % n_m:
        return "moe_tp"
    return "moe_ep" if S % n_m == 0 else "moe_ep_whole"


def _fsdp_and_replicated(cfg, axes):
    """(leaves FSDP cuts summed over the decoder's and the encoder's
    layers, leaves not cut over every wide batch axis): the gathers and
    reduce-scatters a step makes over the FSDP axes, and its all-reduces
    of gradients over the batch axes."""
    mesh = Mesh(axes=axes)
    fsdp = ts.fsdp_axes_of(cfg, mesh)
    shapes = params_shape(cfg)
    shardings = ts.shardings_of(ts.param_specs(cfg, shapes, mesh), mesh)
    wide = set(mesh.wide(ts.batch_axes_for(mesh)))
    F = R = 0
    for sh, leaf in zip(tree.leaves(shardings), tree.leaves(shapes),
                        strict=True):
        spec = sh.spec
        cut = {a for ax in spec if ax is not None
               for a in (ax if isinstance(ax, tuple) else (ax,))}
        if fsdp in spec[1:] and mesh.wide(fsdp):
            F += leaf.shape[0]                  # one gather a layer
        R += not wide <= cut
    return F, R


def expected_collectives(cfg, axes, remat, S, batch_cut=True):
    """Collective calls of one SPMD train step of ``cfg`` on the mesh
    ``axes`` (PERF.md § 6).  On a wide ``model`` axis: the
    embedding's from_model, the logits' to_model backward and gather, and
    each decoder and encoder layer's :data:`PARTS`; remat replays each
    layer's forward collectives up to its last saved tensor.  On wide
    FSDP axes, F gathers (again under remat) and F reduce-scatters; on
    wide batch axes, R all-reduces of the gradients not cut over them and
    the loss's.  One all-reduce of the grad norm."""
    m = axes.get("model", 1) > 1
    moe_part = _moe_part(cfg, axes, S, batch_cut)
    layers = [_layer_parts(cfg, "moe" if sp.moe else sp.kind, moe_part)
              for st in cfg.stages() for _ in range(st.count)
              for sp in st.period]
    layers += [["attn", "mlp"]] * (cfg.n_enc_layers if cfg.is_encdec else 0)
    n = {k: 0 for k in _KINDS}
    if m:
        n["all_reduce"] += 2
        n["all_gather"] += 1
        for parts in layers:
            for i, k in enumerate(_KINDS):
                fwd = sum(PARTS[p][0][i] for p in parts)
                n[k] += fwd + sum(PARTS[p][1][i] for p in parts)
                n[k] += remat * (fwd - PARTS[parts[-1]][2][i])
    F, R = _fsdp_and_replicated(cfg, axes)
    b = any(axes.get(a, 1) > 1 for a in ("pod", "data"))
    n["all_gather"] += F * (1 + remat)
    n["all_reduce"] += b * (R + 1) + 1
    return {**n, "reduce_scatter": F, "broadcast": 0, "ppermute": 0}


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _port_cfg(ref_cfg):
    return ModelConfig(**{f.name: getattr(ref_cfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _ref_cfgs():
    """The reference config of each input case (float32 compute; the MoE
    at ``capacity_factor`` E/K) and its batch shape.  Remat is off: it
    changes memory only, each rank's config sets its own, and the
    reference's jitted steps compile in about two thirds of the time."""
    def f32(arch, **kw):
        return dataclasses.replace(ref_smoke_config(arch), remat=False,
                                   compute_dtype="float32", **kw)
    mix = f32("mixtral-8x7b")
    mix = dataclasses.replace(mix, capacity_factor=mix.n_experts / mix.top_k)
    return {"moe": (mix, 8, 32),
            "moe6": (dataclasses.replace(mix, n_experts=6,
                                         capacity_factor=6 / mix.top_k),
                     8, 32),
            "moe_s30": (mix, 8, 30), "moe_b5": (mix, 5, 32),
            "recurrentgemma-9b": (f32("recurrentgemma-9b"), 8, 32),
            "mamba2-1.3b": (f32("mamba2-1.3b"), 8, 32),
            "whisper-small": (f32("whisper-small"), 8, 32),
            "internvl2-26b": (f32("internvl2-26b"), 8, 32),
            "rglru_w96": (f32("recurrentgemma-9b", rnn_width=96), 8, 32)}


def _case(ref_cfg, B, S, lr=1e-3):
    """A case for the ranks, and the reference's single-device step on it
    as a function to call later: (case, step)."""
    opt = RefAdamW(lr=lr)
    batch = RefData(ref_cfg, B, S, 0).batch_at(0)
    state = jstep.init_train_state(ref_cfg, opt, jax.random.key(0))
    case = {"cfg": _port_cfg(ref_cfg), "opt": AdamWConfig(lr=lr),
            "params": _np(state["params"]), "batch": batch}

    def step():
        s_ref, m_ref = jax.jit(jstep.make_train_step(ref_cfg, opt))(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        return {"metrics": {k: float(v) for k, v in m_ref.items()},
                "state": _np(s_ref)}
    return case, step


def _moe_at(cfg):
    """(stage, period entry) of the first MoE layer."""
    for si, st in enumerate(cfg.stages()):
        for pi, sp in enumerate(st.period):
            if sp.moe:
                return si, pi
    raise ValueError(f"{cfg.name} has no MoE layer")


def _ref_drops(ref_cfg, layer, x, axes):
    """Per rank: the reference's ``_local_dispatch`` → expert FFN →
    ``_local_combine`` on its token block (its batch block over ``data``,
    and its sequence block over ``model`` where EP splits the tokens),
    the capacity the reference's ``ep_capacity`` gives, and the pairs
    dropped."""
    E, K = ref_cfg.n_experts, ref_cfg.top_k
    B, S, d = x.shape
    n_d, n_m = axes["data"], axes["model"]
    tok = E % n_m == 0 and n_m > 1 and S % n_m == 0
    cap, T = ref_ep.ep_capacity(ref_cfg, AbstractMesh((n_d, n_m),
                                                      ("data", "model")),
                                B, S)
    w1, w3, w2 = (jnp.asarray(layer[k]) for k in ("w1", "w3", "w2"))
    out = {}
    for r in range(W.WORLD):
        i, j = r // n_m, r % n_m
        Bl, Sl = B // n_d, (S // n_m if tok else S)
        c0 = j * Sl if tok else 0
        xt = jnp.asarray(x[i * Bl:(i + 1) * Bl, c0:c0 + Sl])
        buf, idx = ref_ep._local_dispatch(xt.reshape(-1, d),
                                          jnp.asarray(layer["router"]), K, E,
                                          cap)
        h = jax.nn.silu(jnp.einsum("ecd,edf->ecf", buf, w1)) \
            * jnp.einsum("ecd,edf->ecf", buf, w3)
        o = jnp.einsum("ecf,efd->ecd", h, w2)
        y = ref_ep._local_combine(o, idx, T).reshape(xt.shape)
        out[r] = {"y": np.asarray(y), "cols": (c0, c0 + Sl),
                  "dropped": int((np.asarray(idx[3]) == 0).sum())}
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The inputs and the reference's drop forwards first, then the 4-rank
    group, and the reference's steps while the ranks run (their compiles
    take most of the module's time): ``(reference, [rank results] or the
    error)``."""
    root = tmp_path_factory.mktemp("mesh_train_stacks")
    inputs, steps, ref = {}, {}, {"steps": {}, "drops": {}}
    rcfgs = _ref_cfgs()
    for name, (rc, B, S) in rcfgs.items():
        inputs[name], steps[name] = _case(rc, B, S)
    rng = np.random.default_rng(0)
    for cid, name, axes in W.DROP_CASES:
        rc = dataclasses.replace(rcfgs[name][0], capacity_factor=1.25)
        case = inputs[name]
        case["drop_cfg"] = _port_cfg(rc)
        si, pi = case["moe_at"] = _moe_at(rc)
        layer = {k: v[0] for k, v in
                 case["params"]["stages"][si][pi]["moe"].items()}
        # a direction every token shares skews the routing, so experts
        # overflow their capacity
        case.setdefault("drop_x", (0.5 * rng.standard_normal(rc.d_model)
                                   + 0.5 * rng.standard_normal(
                                       DROP_SHAPE + (rc.d_model,))
                                   ).astype(np.float32))
        ref["drops"][cid] = _ref_drops(rc, layer, case["drop_x"], axes)
    torch.save(inputs, root / "inputs.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.run, args=(
        r, W.WORLD, str(root / "rdzv"), str(root / "inputs.pt"), str(root)),
        daemon=True) for r in range(W.WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    try:
        for name, step in steps.items():
            ref["steps"][name] = step()
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
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
                 for r in range(W.WORLD)]


def _ranks(spawned):
    res = spawned[1]
    if isinstance(res, str):
        pytest.fail(res)
    return res


def _rel(a, b):
    return abs(a - b) / abs(b)


def _check_step(got, want):
    """A rank-0 result (metrics, whole state) against the reference's."""
    gm, wm = got["metrics"], want["metrics"]
    assert abs(gm["loss"] - wm["loss"]) < LOSS_TOL, (gm, wm)
    assert _rel(gm["grad_norm"], wm["grad_norm"]) < GNORM_RTOL, (gm, wm)
    assert gm["lr"] == pytest.approx(wm["lr"], rel=1e-7)
    s, r = got["state"], want["state"]
    for (k, a), b in zip(tree.leaves_with_path(s["params"]),
                         jax.tree.leaves(r["params"]), strict=True):
        assert a.shape == b.shape, k
        assert np.abs(a.numpy() - b).max() < PARAM_TOL, k
    for m in ("m", "v"):
        for (k, a), b in zip(tree.leaves_with_path(s["opt"][m]),
                             jax.tree.leaves(r["opt"][m]), strict=True):
            err = np.linalg.norm(a.numpy() - b) / np.linalg.norm(b)
            assert err < MOMENT_RTOL, (m, k, err)
    assert int(s["opt"]["step"]) == int(r["opt"]["step"]) == 1


_IDS = [c[0] for c in W.STEP_CASES]


@pytest.mark.parametrize("i", range(len(W.STEP_CASES)), ids=_IDS)
def test_stack_step_matches_reference(spawned, i):
    cid, name = W.STEP_CASES[i][:2]
    ranks = _ranks(spawned)
    _check_step(ranks[0]["steps"][cid], spawned[0]["steps"][name])
    ms = [r["steps"][cid]["metrics"] for r in ranks]
    assert all(m == ms[0] for m in ms), ms


@pytest.mark.parametrize("i", range(len(W.STEP_CASES)), ids=_IDS)
def test_collective_counts_match_formula(spawned, i):
    cid, name, axes, remat, fsdp = W.STEP_CASES[i]
    rc, B, S = _ref_cfgs()[name]
    cfg = dataclasses.replace(_port_cfg(rc), remat=remat, fsdp_axes=fsdp)
    n_b = axes.get("pod", 1) * axes.get("data", 1)
    want = expected_collectives(cfg, axes, remat, S, B % n_b == 0)
    for rank in _ranks(spawned):
        got = rank["steps"][cid]["collectives"]
        assert {k: c["calls"] for k, c in got.items()} == want, cid


@pytest.mark.parametrize("i", range(len(W.STEP_CASES)), ids=_IDS)
def test_counting_mesh_trace_equals_gloo_step(spawned, i):
    """The dry run's trace of the step (rank 0 of a ``CountingMesh`` on
    meta, ``launch/dryrun.py::trace_train_step``) makes the collectives,
    calls and bytes by kind, that the gloo step measured on every
    rank."""
    cid, name, axes, remat, fsdp = W.STEP_CASES[i]
    rc, B, S = _ref_cfgs()[name]
    cfg = dataclasses.replace(_port_cfg(rc), remat=remat, fsdp_axes=fsdp)
    opt = AdamWConfig(lr=1e-3)
    mesh = CountingMesh(axes)
    trace_train_step(cfg, opt, mesh, abstract_train_state(cfg, opt),
                     batch_specs(cfg, B, S))
    for rank in _ranks(spawned):
        assert rank["steps"][cid]["collectives"] == mesh.collectives, cid


@pytest.mark.parametrize("i", range(len(W.DROP_CASES)),
                         ids=[c[0] for c in W.DROP_CASES])
def test_moe_ep_with_drops_matches_reference_dispatch(spawned, i):
    """At the smoke config's own ``capacity_factor`` each rank's
    ``moe_ep`` output, on its token block, equals the reference's local
    dispatch, expert FFN and combine on that block, and the blocks drop
    pairs (so the capacity each rank computes is the reference's)."""
    cid = W.DROP_CASES[i][0]
    want = spawned[0]["drops"][cid]
    assert all(w["dropped"] > 0 for w in want.values())
    for r, rank in enumerate(_ranks(spawned)):
        got = rank["drops"][cid]["y"].numpy()
        lo, hi = want[r]["cols"]
        np.testing.assert_allclose(got[:, lo:hi], want[r]["y"],
                                   atol=DROP_TOL, rtol=0)


def test_stack_ranks_never_load_jax(spawned):
    assert not any(r["jax_loaded"] for r in _ranks(spawned))


# --------------------------------------------------------------------------
# in this process
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ("moe", "recurrentgemma-9b", "mamba2-1.3b",
                                  "whisper-small", "internvl2-26b"))
def test_mesh_1x1_step_matches_unmeshed(name):
    """Two steps on a 1x1 mesh against two unmeshed steps from the same
    params (the reference's), remat on, no collective: bit-equal for the
    dense-MLP
    stacks; the MoE (one dispatch group through ``moe_ep`` where the
    unmeshed step takes the local path's groups, at ``capacity_factor``
    E/K) within the dense bounds."""
    rc, B, S = _ref_cfgs()[name]
    cfg = dataclasses.replace(_port_cfg(rc), remat=True)
    params = params_from_numpy(_np(jm.init_params(rc, jax.random.key(0))),
                               device="cpu")
    opt = AdamWConfig(lr=1e-3)
    plain = {"params": params, "opt": init_opt_state(params, opt)}
    meshed = tree.tree_map(torch.clone, plain)
    mesh = make_host_mesh(1, 1, device="cpu")
    step = make_train_step(cfg, opt)
    for i in range(2):
        batch = {k: torch.from_numpy(v) for k, v in
                 RefData(rc, B, S, 0).batch_at(i).items()}
        plain, m_plain = step(plain, batch)
        with logical_axes(mesh, n_experts=cfg.n_experts):
            meshed, m_mesh = step(meshed, batch)
    if cfg.n_experts:
        assert abs(float(m_plain["loss"]) - float(m_mesh["loss"])) < LOSS_TOL
        assert _rel(float(m_mesh["grad_norm"]),
                    float(m_plain["grad_norm"])) < GNORM_RTOL
        for a, b in zip(tree.leaves(meshed["params"]),
                        tree.leaves(plain["params"]), strict=True):
            assert float((a - b).abs().max()) < PARAM_TOL
    else:
        assert all(torch.equal(m_plain[k], m_mesh[k]) for k in m_plain)
        for a, b in zip(tree.leaves(meshed), tree.leaves(plain), strict=True):
            assert torch.equal(a, b)
    assert all(c["calls"] == 0 for c in mesh.collectives.values())


@pytest.mark.parametrize("name", ("moe", "whisper-small"))
def test_remat_replay_reenters_the_callers_scope(name):
    """A remat replay may run on autograd's device thread, which sees no
    context variable of the caller's (on the card it does): gradients of
    the loss taken on a 1x1 mesh, backward on a fresh thread, equal those
    whose backward runs inside the mesh's scope.  Without the scope the
    MoE's replay would take the local path's groups where its forward
    took ``moe_ep``'s one, and remat would refuse the replay's shapes."""
    from repro_torch.models.model import lm_loss
    rc, B, S = _ref_cfgs()[name]
    cfg = dataclasses.replace(_port_cfg(rc), remat=True)
    params = params_from_numpy(_np(jm.init_params(rc, jax.random.key(0))),
                               device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             RefData(rc, B, S, 0).batch_at(0).items()}
    mesh = make_host_mesh(1, 1, device="cpu")

    def loss_and_leaves():
        views = tree.tree_map(lambda t: t.detach().requires_grad_(True),
                              params)
        return lm_loss(cfg, views, batch), tree.leaves(views)

    with logical_axes(mesh, n_experts=cfg.n_experts):
        loss, flat = loss_and_leaves()
        inside = torch.autograd.grad(loss, flat)
        loss, flat = loss_and_leaves()
    out = {}
    th = threading.Thread(target=lambda: out.setdefault(
        "g", torch.autograd.grad(loss, flat)))
    th.start()
    th.join()
    assert len(out["g"]) == len(inside)
    assert all(torch.equal(a, b) for a, b in zip(out["g"], inside))
