"""The dry run on the meta device (``repro_torch/launch/dryrun.py``,
``perf.py``, ``specs.py``, ``serve/step.py``, the counting mesh of
``launch/mesh.py`` and the step cost walker) against the spawned gloo
runs' collective formulas and the reference's specs, all in this process.

  * one serve token step traced on a ``CountingMesh`` makes the calls and
    bytes by kind of ``test_torch_mesh_serve_data.py::
    expected_collectives`` on that file's whole grid of meshes, layouts
    and stacks (the gloo runs hold the same formula);
  * one SPMD train step traced on a ``CountingMesh`` makes the calls of
    ``test_torch_mesh_train.py::expected_collectives`` and
    ``test_torch_mesh_train_stacks.py::expected_collectives`` on their
    grids (those files also hold the trace to the gloo steps' calls and
    bytes);
  * ``model_flops_estimate`` and ``cell_skip_reason`` equal the
    reference's for all 10 archs x 4 shapes, exactly;
  * ``input_specs``, ``abstract_params``, ``abstract_cache`` and
    ``abstract_train_state`` have ``jax.eval_shape``'s paths, shapes and
    dtypes;
  * ``lower_cell`` of a train cell at smoke widths on both production
    meshes is ``ok`` with the train formula's calls on 256 and 512
    devices; prefill and decode cells trace on both production meshes
    (a decode cell at qwen3-0.6b's full depth with the dense serve file's
    formula, ``test_torch_mesh_serve_dense.py::expected_collectives``; a
    prefill cell cut to one layer, which keeps this file under a minute:
    its chunked attention makes 1.5 M ops at the full 28), ``--quantized``
    decode with fewer parameter bytes a device than dense, a sub-quadratic
    arch's ``long_500k`` with its caches' sequence cut over ``data x
    model``, and a quantized train cell refused as the reference refuses
    it;
  * ``dryrun.main`` and ``perf.main`` write only under ``--out``, and
    ``perf.main`` reports a serve cell against its baseline.
"""
import dataclasses
import json

import jax
import pytest

import _torch_mesh_data_worker as WD
import _torch_mesh_train_stacks_worker as WS
import _torch_mesh_train_worker as WT
import test_torch_mesh_serve_data as TD
import test_torch_mesh_serve_dense as TDense
import test_torch_mesh_train as TT
import test_torch_mesh_train_stacks as TS
from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.launch import specs as jspecs
from repro.models import model as jm
from repro.optim.adamw import AdamWConfig as RefAdamW
from repro.train import step as jstep
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.distributed import hlo_cost
from repro_torch.distributed.hlo_cost import HLO_KIND
from repro_torch.distributed.sharding import shard_params
from repro_torch.launch import dryrun, perf
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import CountingMesh, make_production_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (abstract_cache, abstract_params,
                                      params_shape)
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serve.step import make_prefill_step
from repro_torch.serve.engine import (build_stack_geom, pool_geometry,
                                      trace_token_step)
from repro_torch.train.step import abstract_train_state

SHAPE_NAMES = list(tspecs.SHAPES)
#: the smoke widths a train cell is traced at on the production meshes
#: (the attention chunks keep the full config's 512 and 1,024)
SMOKE = dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
             d_ff=128, vocab=256)


def _calls(mesh):
    return {k: c["calls"] for k, c in mesh.collectives.items()}


# --------------------------------------------------------------------------
# the counting mesh against the gloo runs' formulas
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mesh,arch,layout", TD.COLLECTIVE_CASES,
                         ids=lambda v: TD._label(v) if isinstance(v, tuple)
                         else v)
def test_serve_token_step_collectives_match_formula(mesh, arch, layout):
    cfg, tp = TD._port(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=max(
            cfg.capacity_factor, cfg.n_experts / cfg.top_k))
    shape = {"data": mesh[0], "model": mesh[1]}
    geom = build_stack_geom(cfg, WD.POOL["page_size"])
    mp = WD.POOL["max_pages_per_seq"]
    pool = pool_geometry(cfg, geom, WD.POOL["n_pages"], WD.POOL["page_size"],
                         WD.POOL["max_seqs"], mp)
    blocks = shard_params(cfg, params_shape(cfg), CountingMesh(shape),
                          "meta")
    _, counting = trace_token_step(cfg, geom, shape, layout, blocks, pool,
                                   mp)
    want = TD.expected_collectives(cfg, tp, mesh, layout,
                                   WD.POOL["max_seqs"])
    got = {k: (c["calls"], c["bytes"])
           for k, c in counting.collectives.items()}
    assert {k: got[k] for k in want} == want
    assert all(got[k] == (0, 0) for k in got if k not in want)


def _train_calls(cfg, axes, B, S):
    mesh = CountingMesh(axes)
    opt = AdamWConfig(lr=1e-3)
    dryrun.trace_train_step(cfg, opt, mesh, abstract_train_state(cfg, opt),
                            tspecs.batch_specs(cfg, B, S))
    return _calls(mesh)


@pytest.mark.parametrize("remat", WT.REMATS)
@pytest.mark.parametrize("accum", WT.ACCUMS)
@pytest.mark.parametrize("shape", WT.SHAPES)
def test_train_step_collectives_match_formula(shape, accum, remat):
    cfg = ModelConfig(**TT.DENSE, compute_dtype="float32", grad_accum=accum)
    cfg = dataclasses.replace(cfg, remat=remat)
    got = _train_calls(cfg, {"data": shape[0], "model": shape[1]}, 8, 32)
    assert got == TT.expected_collectives(*shape, TT.DENSE["n_layers"],
                                          accum, remat)


@pytest.mark.parametrize("i", range(len(WS.STEP_CASES)),
                         ids=[c[0] for c in WS.STEP_CASES])
def test_stack_train_step_collectives_match_formula(i):
    cid, name, axes, remat, fsdp = WS.STEP_CASES[i]
    rc, B, S = TS._ref_cfgs()[name]
    cfg = dataclasses.replace(TS._port_cfg(rc), remat=remat, fsdp_axes=fsdp)
    n_b = axes.get("pod", 1) * axes.get("data", 1)
    got = _train_calls(cfg, axes, B, S)
    assert got == TS.expected_collectives(cfg, axes, remat, S,
                                          B % n_b == 0), cid


# --------------------------------------------------------------------------
# specs against the reference's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_skips_equal_the_reference(arch, shape):
    cfg, ref = get_config(arch), ref_get_config(arch)
    assert tspecs.model_flops_estimate(cfg, shape) == \
        jspecs.model_flops_estimate(ref, shape)
    assert tspecs.cell_skip_reason(cfg, shape) == \
        jspecs.cell_skip_reason(ref, shape)


def _port_leaves(tree_):
    return [(k, tuple(t.shape), str(t.dtype).removeprefix("torch."),
             t.device.type) for k, t in tree.leaves_with_path(tree_)]


def _ref_leaves(tree_):
    return [(jax.tree_util.keystr(k), tuple(x.shape), str(x.dtype), "meta")
            for k, x in jax.tree_util.tree_flatten_with_path(tree_)[0]]


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_eval_shape(arch, shape):
    """At smoke widths (the reference's ``jax.eval_shape`` of a full
    config's init is slow to trace; the trees' structure is the same):
    paths, shapes and dtypes of every leaf, all on meta."""
    cfg, ref = smoke_config(arch), ref_smoke_config(arch)
    got = _port_leaves(tspecs.input_specs(cfg, shape))
    assert got == _ref_leaves(jspecs.input_specs(ref, shape))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-9b",
                                  "whisper-small"])
def test_abstract_trees_match_eval_shape(arch):
    """Full widths: ``abstract_params``, ``abstract_cache`` and
    ``abstract_train_state`` (bfloat16 moments too)."""
    cfg, ref = get_config(arch), ref_get_config(arch)
    assert _port_leaves(abstract_params(cfg)) == \
        _ref_leaves(jm.abstract_params(ref))
    assert _port_leaves(abstract_cache(cfg, 2, 48)) == \
        _ref_leaves(jm.abstract_cache(ref, 2, 48))
    opt, ref_opt = (AdamWConfig(state_dtype="bfloat16"),
                    RefAdamW(state_dtype="bfloat16"))
    assert _port_leaves(abstract_train_state(cfg, opt)) == \
        _ref_leaves(jstep.abstract_train_state(ref, ref_opt))


# --------------------------------------------------------------------------
# lower_cell, dryrun.main and perf.main
# --------------------------------------------------------------------------
def test_production_meshes_count_without_a_group():
    for multi, n in ((False, 256), (True, 512)):
        mesh = make_production_mesh(multi_pod=multi, counting=True)
        assert mesh.size == n and mesh.rank == 0
        assert mesh.device_type == "meta"
        assert all(c == 0 for c in mesh.coords.values())


@pytest.mark.parametrize("multi", [False, True])
def test_lower_cell_traces_a_train_cell(multi):
    rec = dryrun.lower_cell("qwen3-0.6b", "train_4k", multi,
                            overrides=SMOKE)
    assert rec["ok"] and not rec["skipped"], rec.get("error")
    axes = make_production_mesh(multi_pod=multi, counting=True).shape
    assert rec["n_devices"] == (512 if multi else 256)
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), **SMOKE)
    want = TS.expected_collectives(cfg, axes, cfg.remat, 4096)
    got = {k: int(rec["collective_counts"][HLO_KIND[k]]) for k in want}
    assert got == want
    r = rec["roofline"]
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert r["flops_per_device"] > 0 and r["coll_bytes_per_device"] > 0
    mem = rec["memory"]
    assert rec["bytes_per_device_live"] == (
        mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
        + mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"])
    assert mem["temp_size_in_bytes"] > 0
    assert rec["model_flops"] == tspecs.model_flops_estimate(cfg, "train_4k")
    assert 0 < rec["useful_flops_ratio"] < 1
    assert [row["trips"] for row in rec["stage_loops"]] == [2.0]
    for gone in ("compile_s", "xla_cost_analysis"):
        assert gone not in rec


def _check_serve_record(rec, cfg, shape, multi):
    """The keys a traced serve cell writes, and its memory's parts."""
    assert rec["ok"] and not rec["skipped"], rec.get("error")
    assert rec["n_devices"] == (512 if multi else 256)
    r = rec["roofline"]
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert r["flops_per_device"] > 0 and r["coll_bytes_per_device"] > 0
    mem = rec["memory"]
    assert rec["bytes_per_device_live"] == (
        mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
        + mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"])
    assert mem["temp_size_in_bytes"] > 0
    decode = tspecs.SHAPES[shape]["kind"] == "decode"
    assert (mem["alias_size_in_bytes"] > 0) == decode
    assert rec["model_flops"] == tspecs.model_flops_estimate(cfg, shape)
    # a decode step does the estimate's work; a prefill computes the
    # logits at the last position alone, which the estimate counts at
    # every one, so its ratio passes 1 where attention does not dominate
    # (the one-layer cell): test_serve_cells_record_the_a15b_iii_error
    # holds it to the unmeshed step instead
    assert 0 < rec["useful_flops_ratio"] < (1.1 if decode else 2.0)
    assert [row["trips"] for row in rec["stage_loops"]] == [
        float(st.count) for st in cfg.stages()]


#: the serve cells' depth: decode at the published 28 layers, prefill cut
#: to one (module doc)
SERVE_DEPTH = {"prefill_32k": {"n_layers": 1}, "decode_32k": {}}


@pytest.mark.parametrize("shape,quantized", [("prefill_32k", False),
                                             ("decode_32k", False),
                                             ("train_4k", True)])
def test_serve_cells_record_the_a15b_iii_error(shape, quantized):
    """Prefill and decode cells of qwen3-0.6b trace on both production
    meshes (the decode's collective calls are the dense serve formula's);
    a quantized train cell raises the reference's refusal, which
    ``dryrun.main`` records."""
    if quantized:
        with pytest.raises(AssertionError, match="serving-only"):
            dryrun.lower_cell("qwen3-0.6b", shape, False, quantized=True)
        return
    over = SERVE_DEPTH[shape]
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), **over)
    sh = tspecs.SHAPES[shape]
    if shape == "prefill_32k":
        plain = hlo_cost.trace_step(
            make_prefill_step(cfg, sh["seq"]),
            tspecs.input_specs(cfg, shape)[0],
            tspecs.batch_specs(cfg, sh["batch"], sh["seq"])).report()["flops"]
    for multi in (False, True):
        rec = dryrun.lower_cell("qwen3-0.6b", shape, multi, overrides=over)
        _check_serve_record(rec, cfg, shape, multi)
        if shape == "prefill_32k":
            # 16 query heads split over the 16-wide model axis: each rank
            # attends with its one head and nothing is whole on every
            # rank, so the mesh's FLOPs are one device's step's and 1%
            # more at most (the norms and residuals, whole over model)
            assert rec["whole_over_model"] == []
            total = rec["roofline"]["flops_per_device"] * rec["n_devices"]
            assert plain <= total <= 1.01 * plain, (total, plain)
        if shape == "decode_32k":
            axes = make_production_mesh(multi_pod=multi, counting=True).shape
            want = TDense.expected_collectives(cfg, axes, sh["batch"],
                                               sh["seq"])
            assert {k: int(rec["collective_counts"][HLO_KIND[k]])
                    for k in want} == want


@pytest.mark.parametrize("arch,M,want", [
    ("qwen3-0.6b", 16, []), ("gemma3-12b", 16, []),
    ("whisper-small", 16, ["attention (12 heads over 16)"]),
    ("whisper-small", 4, []), ("whisper-small", 1, []),
    ("recurrentgemma-9b", 16, ["rglru scan"]),
    ("mamba2-1.3b", 16, ["mamba scan"])])
def test_prefill_record_names_what_is_whole_over_model(arch, M, want):
    """A prefill cell's ``whole_over_model``: attention whose query heads
    do not split over ``model`` (whisper's 12 over 16; qwen3's 16 and
    gemma3's 16 do, each rank's one head inside one kv head) and the
    recurrent scans, which run whole on every rank."""
    assert dryrun.whole_over_model(get_config(arch), M) == want


def _param_bytes(rec):
    """A decode cell's parameter bytes a device: its arguments less the
    caches (aliased) and the one token column."""
    mem = rec["memory"]
    return mem["argument_size_in_bytes"] - mem["alias_size_in_bytes"]


def test_quantized_decode_cell_holds_fewer_param_bytes():
    """``--quantized`` decode of qwen3-0.6b on the 16 x 16 mesh: the same
    record keys, int8 blocks (fewer parameter bytes a device than the
    dense cell), two all-reduces a row block more a layer (the row scale's
    max, the int32 sum), and the formula's calls."""
    cfg = get_config("qwen3-0.6b")
    dense = dryrun.lower_cell("qwen3-0.6b", "decode_32k", False)
    q8 = dryrun.lower_cell("qwen3-0.6b", "decode_32k", False,
                           quantized=True)
    qcfg = dataclasses.replace(cfg, quantize_bits=8)
    _check_serve_record(q8, qcfg, "decode_32k", False)
    assert q8["quantized"] and _param_bytes(q8) < _param_bytes(dense)
    axes = make_production_mesh(counting=True).shape
    want = TDense.expected_collectives(cfg, axes, 128, 32768, q8=True)
    assert {k: int(q8["collective_counts"][HLO_KIND[k]])
            for k in want} == want
    ar = HLO_KIND["all_reduce"]
    assert q8["collective_counts"][ar] - dense["collective_counts"][ar] \
        == 2 * cfg.n_layers


@pytest.mark.parametrize("arch", ["gemma3-12b", "recurrentgemma-9b"])
def test_long_context_cell_cuts_the_sequence_over_data_and_model(arch):
    """A sub-quadratic arch's ``long_500k`` (batch 1) on the 16 x 16 mesh:
    the batch axes cannot cut one sequence, so every cache's sequence is
    cut over ``data x model`` (256 blocks): each attention layer's
    combine makes the formula's two all-reduces, and a rank's caches are
    the whole caches' 256th where the sequence divides."""
    cfg = get_config(arch)
    rec = dryrun.lower_cell(arch, "long_500k", False)
    _check_serve_record(rec, cfg, "long_500k", False)
    axes = make_production_mesh(counting=True).shape
    want = TDense.expected_collectives(cfg, axes, 1, 524288)
    assert {k: int(rec["collective_counts"][HLO_KIND[k]])
            for k in want} == want
    whole = sum(t.nelement() * t.element_size() for t in
                tree.leaves(abstract_cache(cfg, 1, 524288))
                if t.dim() == 5)
    assert rec["memory"]["alias_size_in_bytes"] < whole / 16


def test_dryrun_main_writes_only_under_out(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "o"
    dryrun.main(["--arch", "qwen3-0.6b", "--shape", "long_500k",
                 "--mesh", "both", "--out", str(out)])
    with pytest.raises(SystemExit, match="1 cells failed"):
        dryrun.main(["--arch", "qwen3-0.6b", "--shape", "train_4k",
                     "--mesh", "single", "--quantized", "--out", str(out)])
    assert [p.name for p in tmp_path.iterdir()] == ["o"]
    assert sorted(p.name for p in out.iterdir()) == [
        "qwen3-0.6b_long_500k_multi.json",
        "qwen3-0.6b_long_500k_single.json",
        "qwen3-0.6b_train_4k_single_q8.json"]
    text = capsys.readouterr().out
    assert "skipped" in text and "serving-only" in text


def test_perf_main_reports_against_the_baseline(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "o"
    base = dryrun.lower_cell("qwen3-0.6b", "train_4k", False,
                             overrides=SMOKE)
    out.mkdir()
    (out / "qwen3-0.6b_train_4k_single.json").write_text(json.dumps(base))
    sets = [f"{k}={v}" for k, v in SMOKE.items()]
    perf.main(["--arch", "qwen3-0.6b", "--shape", "train_4k", "--tag",
               "noremat", "--out", str(out)]
              + [a for kv in sets + ["remat=false"] for a in ("--set", kv)])
    text = capsys.readouterr().out
    assert "[noremat]" in text and "step:" in text
    rec = json.loads((out / "qwen3-0.6b_train_4k_single_noremat.json")
                     .read_text())
    assert rec["ok"] and rec["overrides"]["remat"] is False
    assert rec["roofline"]["flops_per_device"] < \
        base["roofline"]["flops_per_device"]
    assert [p.name for p in tmp_path.iterdir()] == ["o"]


def test_perf_main_reports_a_serve_cell(tmp_path, monkeypatch, capsys):
    """``perf.main`` on a decode cell, unchanged: qwen3-0.6b's
    ``decode_32k`` against its baseline with half the layers."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "o"
    out.mkdir()
    base = dryrun.lower_cell("qwen3-0.6b", "decode_32k", False)
    (out / "qwen3-0.6b_decode_32k_single.json").write_text(json.dumps(base))
    perf.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--tag",
               "half", "--set", "n_layers=14", "--out", str(out)])
    text = capsys.readouterr().out
    assert "[half]" in text and "step:" in text
    rec = json.loads((out / "qwen3-0.6b_decode_32k_single_half.json")
                     .read_text())
    assert rec["ok"] and rec["overrides"] == {"n_layers": 14}
    assert rec["roofline"]["flops_per_device"] < \
        base["roofline"]["flops_per_device"]
