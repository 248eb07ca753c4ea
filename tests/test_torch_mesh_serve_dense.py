"""The dense serve steps on a device mesh in the port: ``prefill`` and
``decode_step`` (``serve/step.py``) on ``data x model`` meshes with the
params cut by ``param_specs``, the caches by ``cache_specs``
(``CacheBlocks``) and the batch by ``batch_spec``; the sequence-parallel
decode attention; int8 weights on a wide ``model`` axis, in the steps and
in the engine.

As in ``test_torch_mesh_train_stacks.py`` (whose pattern this file
follows), the reference's single-device jitted ``prefill`` and greedy
``decode_step`` run in this process before the ranks start; one gloo group
each of 2, 4 and 8 ranks is spawned for the module
(``_torch_mesh_dense_worker.run``, which imports no JAX; a file
rendezvous, every collective bounded by 60 s, the parent kills ranks
still alive after ``JOIN_S`` and fails their tests), and each case builds
its own mesh over its group.  Each case prefills B prompts and takes
``N_DECODE`` greedy steps.

Tolerances, each with its reason:
  * logits within ``LOGIT_TOL`` (1e-5) of the largest |logit| of the
    reference's, float32 compute: the meshed products sum their partial
    rows and the sequence-parallel softmax its partials in another order
    than one device; greedy tokens equal.  The MoE configs set
    ``capacity_factor`` to E/K on both sides, as the engine does on a
    mesh, so neither side drops a token;
  * the caches each rank holds against ``cache_specs``' blocks of the
    port's unmeshed caches (the reference's tokens fed): the same bound;
  * int8 weights: 1e-4 absolute and relative, as in
    ``test_torch_quantized.py`` (an activation within float32 rounding of
    a code boundary may round to the other code);
  * collective calls of one decode step equal :func:`expected_collectives`
    (PERF.md § 6), and the dry run's trace of the same step on a
    ``CountingMesh`` makes the gloo step's calls and bytes by kind;
  * on a 1x1 mesh (in this process) every stack is bit-equal to no mesh
    and makes no collective.
"""
import dataclasses
import multiprocessing as mp
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_dense_worker as W
from _torch_parity import (jax_decode_step, jax_greedy,  # noqa: F401
                           one_torch_thread)
from repro.configs import smoke_config as ref_smoke_config
from repro.models import model as jm
from repro.models.quantized import \
    quantize_serving_params as ref_quantize
from repro_torch import tree
from repro_torch.distributed import sharding as ts
from repro_torch.distributed.axes import logical_axes
from repro_torch.launch.dryrun import trace_serve_step
from repro_torch.launch.mesh import CountingMesh, Mesh, make_host_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (abstract_params, heads_cut_on,
                                      params_from_numpy, params_shape)
from repro_torch.models.quantized import quantize_serving_params
from repro_torch.serve.step import make_decode_step, make_prefill_step

#: the ranks' time limit (both groups)
JOIN_S = 240
LOGIT_TOL = 1e-5
Q8_TOL = dict(atol=1e-4, rtol=1e-4)


def _port_cfg(ref_cfg):
    return ModelConfig(**{f.name: getattr(ref_cfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _ref_cases():
    """Input case → (reference config at float32 compute, B, prompt
    length, cache length).  The MoE at ``capacity_factor`` E/K; gemma3's
    20-token prompts fill its 16-token rings past their end."""
    def f32(arch, **kw):
        return dataclasses.replace(ref_smoke_config(arch),
                                   compute_dtype="float32", **kw)
    mix = f32("mixtral-8x7b")
    mix = dataclasses.replace(mix, capacity_factor=mix.n_experts / mix.top_k)
    qwen, gemma, whisper = (f32("qwen3-0.6b"), f32("gemma3-12b"),
                            f32("whisper-small"))
    return {"qwen3-0.6b": (qwen, 2, 16, 24), "qwen3-b1": (qwen, 1, 16, 24),
            "qwen3-b4": (qwen, 4, 16, 24), "qwen3-len25": (qwen, 2, 16, 25),
            "gemma3-12b": (gemma, 2, 20, 24), "gemma3-b1": (gemma, 1, 20, 24),
            "recurrentgemma-9b": (f32("recurrentgemma-9b"), 2, 16, 24),
            "mamba2-1.3b": (f32("mamba2-1.3b"), 2, 16, 24),
            "whisper-small": (whisper, 2, 8, 16),
            "whisper-b1": (whisper, 1, 8, 16),
            "whisper-f15": (dataclasses.replace(whisper, n_audio_frames=15),
                            2, 8, 16),
            "mixtral-8x7b": (mix, 2, 16, 24)}


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _batch(rc, B, S, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, rc.vocab, (B, S)).astype(np.int32)}
    if rc.is_encdec:
        out["audio_frames"] = rng.standard_normal(
            (B, rc.n_audio_frames, rc.d_model)).astype(np.float32)
    return out


@jax.jit
def _argmax(logits):
    return jnp.argmax(logits, -1).astype(jnp.int32)


def _reference(rc, jp, batch, max_len, pos):
    """The reference's single-device jitted prefill and ``N_DECODE``
    greedy decode steps: logits and tokens (numpy), step by step."""
    logits, caches = jax.jit(jm.prefill, static_argnums=(0, 3))(
        rc, jp, {k: jnp.asarray(v) for k, v in batch.items()}, max_len)
    out = {"logits": [np.asarray(logits)], "tokens": [np.asarray(
        _argmax(logits))]}
    for i in range(W.N_DECODE):
        logits, caches = jax_decode_step(rc, jp, caches,
                                         jnp.asarray(out["tokens"][-1]),
                                         jnp.int32(pos + i))
        out["logits"].append(np.asarray(logits))
        out["tokens"].append(np.asarray(_argmax(logits)))
    return out


def _unmeshed(cfg, params, batch, max_len, pos, tokens, mesh=None):
    """The port's prefill and decode steps with no mesh (or inside a
    1x1 mesh's ``logical_axes``), fed ``tokens``: (logits of each step,
    the caches after the prefill, the caches after the last step)."""
    from contextlib import nullcontext
    scope = (nullcontext() if mesh is None else
             logical_axes(mesh, n_experts=cfg.n_experts))
    with scope:
        logits, caches = make_prefill_step(cfg, max_len)(
            params, {k: torch.from_numpy(v) for k, v in batch.items()})
        first = tree.tree_map(torch.clone, list(caches))
        out = [logits]
        for i in range(W.N_DECODE):
            logits, caches = make_decode_step(cfg)(
                params, caches, torch.tensor(tokens[i]), pos + i)
            out.append(logits)
    return out, first, list(caches)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The inputs and the reference's runs first, then both groups, and
    the port's unmeshed runs while the ranks run: ``(reference, unmeshed,
    {world: [rank results] or the error})``."""
    root = tmp_path_factory.mktemp("mesh_dense")
    inputs, ref, plain, params = {}, {}, {}, {}
    for i, (name, (rc, B, S, L)) in enumerate(_ref_cases().items()):
        jp = jm.init_params(rc, jax.random.key(0))
        batch = _batch(rc, B, S, i)
        inputs[name] = {"cfg": _port_cfg(rc), "params": _np(jp),
                        "batch": batch, "max_len": L, "pos": S}
        ref[name, False] = _reference(rc, jp, batch, L, S)
        params[name] = jp
    rc, _, S, L = _ref_cases()["qwen3-0.6b"]
    qp = ref_quantize(params["qwen3-0.6b"])
    ref["qwen3-0.6b", True] = _reference(rc, qp, inputs["qwen3-0.6b"][
        "batch"], L, S)
    rng = np.random.default_rng(7)
    name, plen, max_new = W.ENGINE_Q8
    inputs["engine_prompts"] = [
        rng.integers(0, rc.vocab, plen).tolist() for _ in range(2)]
    ref["engine_q8"] = {i: jax_greedy(rc, qp, p, max_new)
                        for i, p in enumerate(inputs["engine_prompts"])}
    torch.save(inputs, root / "inputs.pt")
    ctx = mp.get_context("spawn")
    procs = {}
    for world in W.CASES:
        d = root / f"w{world}"
        d.mkdir()
        procs[world] = [ctx.Process(target=W.run, args=(
            r, world, str(d / "rdzv"), str(root / "inputs.pt"), str(d)),
            daemon=True) for r in range(world)]
    for ps in procs.values():
        for p in ps:
            p.start()
    deadline = time.monotonic() + JOIN_S
    res = {}
    try:
        for name, case in inputs.items():
            if name == "engine_prompts":
                continue
            cfg = case["cfg"]
            tp = params_from_numpy(case["params"], device="cpu")
            for q8 in (False, True) if name == "qwen3-0.6b" else (False,):
                toks = ref[name, q8]["tokens"]
                plain[name, q8] = _unmeshed(
                    cfg, quantize_serving_params(tp) if q8 else tp,
                    case["batch"], case["max_len"], case["pos"], toks)
        for world, ps in procs.items():
            for p in ps:
                p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for world, ps in procs.items():
            hung = [r for r, p in enumerate(ps) if p.is_alive()]
            for p in ps:
                if p.is_alive():
                    p.kill()
                    p.join(10)
            d = root / f"w{world}"
            errs = [f"rank {r}:\n{(d / f'rank{r}.err').read_text()}"
                    for r in range(world) if (d / f"rank{r}.err").exists()]
            if hung or errs or any(p.exitcode for p in ps):
                res[world] = (f"hung {hung} (killed after {JOIN_S} s), exit "
                              f"codes {[p.exitcode for p in ps]}\n"
                              + "\n".join(errs))
            else:
                res[world] = [torch.load(d / f"rank{r}.pt",
                                         weights_only=False)
                              for r in range(world)]
    return ref, plain, res


def _ranks(spawned, world):
    res = spawned[2][world]
    if isinstance(res, str):
        pytest.fail(res)
    return res


_ALL = [(world, c) for world, cs in W.CASES.items() for c in cs]
_IDS = [c[0] for _, c in _ALL]


def _rows(mesh_axes, rank, B):
    """This rank's rows of a batch of B: its block over the batch axes
    (``pod x data``) where they divide B, else all of them."""
    D, M = mesh_axes.get("pod", 1) * mesh_axes["data"], mesh_axes["model"]
    if D == 1 or B % D:
        return slice(0, B)
    i = rank // M
    return slice(i * (B // D), (i + 1) * (B // D))


@pytest.mark.parametrize("world,case", _ALL, ids=_IDS)
def test_mesh_steps_match_reference(spawned, world, case):
    """Every rank's logits of the prefill and each decode step against the
    reference's single-device steps on its rows, and its greedy tokens
    equal."""
    cid, name, axes, q8 = case
    want = spawned[0][name, q8]
    for r, rank in enumerate(_ranks(spawned, world)):
        got = rank["serve"][cid]
        rows = _rows(axes, r, want["tokens"][0].shape[0])
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            w = w[rows]
            if q8:
                np.testing.assert_allclose(g.numpy(), w, **Q8_TOL)
            else:
                err = np.abs(g.numpy() - w).max() / np.abs(w).max()
                assert err <= LOGIT_TOL, (cid, r, i, err)
        for i, (g, w) in enumerate(zip(got["tokens"], want["tokens"])):
            assert np.array_equal(g.numpy(), w[rows]), (cid, r, i)


def _blocks(cfg, caches, axes, rank, B):
    """``cache_specs``' blocks of whole caches for ``rank`` of ``axes``."""
    mesh = Mesh(axes=axes, rank=rank)
    sh = ts.shardings_of(ts.cache_specs(cfg, caches, mesh, B), mesh)
    return tree.leaves(tree.map_with_path(lambda _, x, s: s.local(x),
                                          caches, sh))


@pytest.mark.parametrize("world,case", _ALL, ids=_IDS)
def test_mesh_cache_blocks_match_unmeshed(spawned, world, case):
    """Each rank's caches after the prefill and after the last decode
    step are ``CacheBlocks`` equal to ``cache_specs``' blocks of the
    port's unmeshed caches, fed the reference's tokens."""
    cid, name, axes, q8 = case
    rc, B = _ref_cases()[name][:2]
    cfg = _port_cfg(rc)
    _, first, last = spawned[1][name, q8]
    for r, rank in enumerate(_ranks(spawned, world)):
        got = rank["serve"][cid]
        assert got["is_blocks"] == "CacheBlocks"
        for mine, whole in ((got["prefill_caches"], first),
                            (got["caches"], last)):
            for g, w in zip(tree.leaves(mine),
                            _blocks(cfg, whole, axes, r, B), strict=True):
                assert g.shape == w.shape, (cid, r)
                scale = max(float(w.abs().max()), 1.0)
                err = float((g - w).abs().max()) / scale
                assert err <= (Q8_TOL["atol"] if q8 else LOGIT_TOL), \
                    (cid, r, err)


def _fsdp_gathers(cfg, axes, q8):
    """One all-gather a decoder layer per dtype among its leaves that
    ``param_specs`` cuts over a wide ``data`` axis (the serve form of
    ``fsdp_layer``), summed over the layers."""
    if axes["data"] == 1:
        return 0
    shapes = params_shape(cfg)
    if q8:
        shapes = quantize_serving_params(shapes)
    specs = ts.param_specs(cfg, shapes, Mesh(axes=axes))
    n = 0
    for st, sts, sps in zip(cfg.stages(), shapes["stages"],
                            specs["stages"]):
        for leaves, spec in zip(sts, sps):
            n += st.count * len(_cut_dtypes(leaves, spec))
    return n


def _cut_dtypes(leaves, spec):
    """The dtypes of the leaves of one layer's subtree whose spec cuts a
    dim (after the stack dim) over ``data``."""
    out = set()
    if isinstance(leaves, dict):
        for k in leaves:
            out |= _cut_dtypes(leaves[k], spec[k])
    elif "data" in spec[1:]:
        out.add(leaves.dtype)
    return out


def expected_collectives(cfg, axes, B, L, q8=False):
    """Collective calls of one decode step of ``cfg`` on the mesh ``axes``
    (``data x model``, D x M, or ``pod x data x model``, whose batch axes
    are P·D wide): B sequences against caches of L (PERF.md § 6).

    Over ``data``: one all-gather a layer per dtype of its FSDP blocks.
    Over a wide ``model`` axis: one all-reduce of the embedding; a
    layer's attention one all-gather of q|k|v (of k|v alone where the
    cache is whole over its sequence and the heads split over ``model``,
    ``heads_cut_on``: none where k and v are whole too) and one
    all-reduce of ``wo``'s row block (two with int8 weights: the row
    scale's max and the int32 sum), the cross-attention one all-gather of
    q (none where its frames are whole and the heads split) and ``wo``'s
    one or two; the MLP ``w2``'s one or two; RG-LRU one all-gather (the
    gates' input) and one all-reduce (``out``); Mamba-2 three all-gathers
    (the projection, the conv output, y) and one all-reduce
    (``out_proj``); the MoE two all-to-alls under EP and one all-gather
    more where its tokens split over ``model`` (B > 1 rows on a 1-wide
    ``data`` axis that ``model`` divides), the experts gathered whole in
    three all-gathers where a wide ``data`` axis does not cut the batch,
    one all-reduce under the TP fallback; one all-gather of the logits'
    vocab blocks.  Over the sequence axes (``model`` where the batch axes
    divide B, else ``data x model``; a cache whose length they do not
    divide stays whole): two all-reduces a layer whose self-attention
    cache, or cross-attention frames, are cut: the running max, and the
    weighted sums and denominators in one."""
    M = axes["model"]
    D = axes.get("pod", 1) * axes["data"]
    rows_cut = D > 1 and B % D == 0
    n_seq = M if rows_cut or D == 1 else axes["data"] * M
    n = {"all_reduce": 0, "all_gather": _fsdp_gathers(cfg, axes, q8),
         "all_to_all": 0}
    wide = M > 1
    row = 1 + q8

    def seq_cut(S):
        return n_seq > 1 and S % n_seq == 0

    heads = heads_cut_on(cfg, M)
    kv_cut = cfg.n_kv * cfg.head_dim % M == 0

    n["all_reduce"] += wide
    for st in cfg.stages():
        for sp in st.period:
            c = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0}
            if sp.kind in ("attn", "local"):
                w = sp.window or cfg.window
                S_c = min(w, L) if w else L
                c["all_gather"] += wide and (seq_cut(S_c) or not heads
                                             or kv_cut)
                c["all_reduce"] += row * wide + 2 * seq_cut(S_c)
            elif sp.kind == "rglru":
                c["all_gather"] += wide
                c["all_reduce"] += wide
            elif sp.kind == "mamba":
                c["all_gather"] += 3 * wide
                c["all_reduce"] += wide
            if cfg.is_encdec:
                c["all_gather"] += wide and (seq_cut(cfg.n_audio_frames)
                                             or not heads)
                c["all_reduce"] += row * wide + 2 * seq_cut(
                    cfg.n_audio_frames)
            if sp.moe and wide:
                if D > 1 and not rows_cut:
                    c["all_gather"] += 3
                elif cfg.n_experts % M == 0:
                    c["all_to_all"] += 2
                    c["all_gather"] += D == 1 and B > 1 and B % M == 0
                else:
                    c["all_reduce"] += 1
            elif sp.kind != "mamba":
                c["all_reduce"] += row * wide
            for k in c:
                n[k] += st.count * c[k]
    n["all_gather"] += wide
    return {**n, "reduce_scatter": 0, "broadcast": 0, "ppermute": 0}


@pytest.mark.parametrize("world,case", _ALL, ids=_IDS)
def test_decode_collectives_match_formula(spawned, world, case):
    cid, name, axes, q8 = case
    rc, B, _, L = _ref_cases()[name]
    want = expected_collectives(_port_cfg(rc), axes, B, L, q8)
    for rank in _ranks(spawned, world):
        got = rank["serve"][cid]["collectives"]
        assert {k: c["calls"] for k, c in got.items()} == want, cid


@pytest.mark.parametrize("world,case", _ALL, ids=_IDS)
def test_counting_mesh_trace_equals_gloo_step(spawned, world, case):
    """The dry run's trace of the decode step (rank 0 of a
    ``CountingMesh`` on meta, ``launch/dryrun.py::trace_serve_step``)
    makes the collectives, calls and bytes by kind, that the gloo step
    measured on every rank."""
    cid, name, axes, q8 = case
    rc, B, _, L = _ref_cases()[name]
    cfg = _port_cfg(rc)
    params = abstract_params(cfg)
    if q8:
        params = quantize_serving_params(params)
    mesh = CountingMesh(axes)
    trace_serve_step(cfg, mesh, "decode", B, L, params)
    for rank in _ranks(spawned, world):
        assert rank["serve"][cid]["collectives"] == mesh.collectives, cid


def test_engine_q8_on_a_wide_model_axis_serves_unmeshed_tokens(spawned):
    """The engine with int8 weights on a 1x2 mesh (``wo`` and ``w2``
    through ``qmm_row_block``) serves the unmeshed int8 engine's greedy
    tokens on both ranks."""
    ranks = _ranks(spawned, 2)
    plain = ranks[0]["engine_q8"]["plain"]
    assert plain and all(len(v) == W.ENGINE_Q8[2] for v in plain.values())
    for rank in ranks:
        assert rank["engine_q8"]["meshed"] == plain


def test_engine_q8_unmeshed_serves_reference_tokens(spawned):
    """The unmeshed engine with int8 weights (the paged prefill and
    decode through ``qmm``) serves the reference's greedy tokens of its
    quantized dense ``prefill`` and ``decode_step`` on the same prompts:
    the independent hold on the int8 engine that the meshed-equals-
    unmeshed check above leans on."""
    plain = _ranks(spawned, 2)[0]["engine_q8"]["plain"]
    assert plain == spawned[0]["engine_q8"]


def test_counting_mesh_refuses_a_tuple_no_group_spans():
    """A collective over a tuple of axes that no process group of a real
    mesh of the same shape spans raises on the ``CountingMesh``, as it
    would on the mesh (``launch/mesh.py::_group_keys``); the tuples the
    serve steps use are there."""
    mesh = CountingMesh({"pod": 2, "data": 2, "model": 2})
    x = torch.zeros(4, device="meta")
    for ok in ("model", ("data", "model"), ("pod", "data"),
               ("pod", "data", "model")):
        mesh.all_reduce(x, ok)
    with pytest.raises(ValueError, match="no process group"):
        mesh.all_reduce(x, ("pod", "model"))
    with pytest.raises(ValueError, match="no process group"):
        mesh.all_gather(x, 0, ("pod", "model"))
    assert mesh.collectives["all_reduce"]["calls"] == 4


def test_dense_ranks_never_load_jax(spawned):
    assert not any(r["jax_loaded"] for w in W.CASES
                   for r in _ranks(spawned, w))


# --------------------------------------------------------------------------
# in this process
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ("qwen3-0.6b", "gemma3-12b",
                                  "recurrentgemma-9b", "mamba2-1.3b",
                                  "whisper-small", "mixtral-8x7b"))
def test_mesh_1x1_steps_bit_equal_unmeshed(spawned, name):
    """The steps inside a 1x1 mesh's ``logical_axes`` (``CacheBlocks``
    whole on its one device) against no mesh: logits and caches
    bit-equal, no collective."""
    rc, B, S, L = _ref_cases()[name]
    cfg = _port_cfg(rc)
    tp = params_from_numpy(_np(jm.init_params(rc, jax.random.key(0))),
                           device="cpu")
    batch = _batch(rc, B, S, 0)
    toks = spawned[0][name, False]["tokens"]
    mesh = make_host_mesh(1, 1, device="cpu")
    got = _unmeshed(cfg, tp, batch, L, S, toks, mesh)
    want = _unmeshed(cfg, tp, batch, L, S, toks)
    for g, w in zip(tree.leaves(got), tree.leaves(want), strict=True):
        assert torch.equal(g, w)
    assert all(c["calls"] == 0 for c in mesh.collectives.values())
