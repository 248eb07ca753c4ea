"""Multi-pod dry run (counterpart of ``repro/launch/dryrun.py``): trace
one rank's step of every (architecture × input shape × mesh) cell and
extract its roofline terms, with no card and no process group.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --mesh both

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The reference forces 512 fake host devices, lowers each cell under
``jax.make_mesh`` and reads the compiled, SPMD-partitioned HLO.  Here a
cell runs rank 0's step in eager PyTorch on ``device="meta"`` (shapes,
no storage) on the production mesh as a ``launch/mesh.py::CountingMesh``
(``data 16 x model 16``, or ``pod 2 x data 16 x model 16``), under the
step cost walker (``distributed/hlo_cost.py``); the roofline uses the
H100's constants (``distributed/hlo_analysis.py``).  A train cell traces
the SPMD train step: the state ``abstract_train_state`` cut by
``state_specs`` (``shard_state``), the global batch cut by
``batch_spec`` inside the step, the optimizer config :func:`_opt_cfg`.
A prefill or decode cell traces ``serve/step.py``'s step on the mesh
(:func:`trace_serve_step`): the params ``abstract_params`` (int8 first
under ``--quantized``: ``quantize_serving_params`` of the meta tree) cut
by ``param_specs`` (``shard_params``), the decode caches
``abstract_cache``'s blocks by ``cache_specs``, the batch cut by
``batch_spec`` (``cache_specs`` cuts a decode cache's sequence over
``data x model`` where the batch axes do not divide the batch, as at
the reference's decode batch 1).  A quantized train cell records the
reference's refusal.

Each cell writes one JSON artifact under ``--out`` (default
``results/dryrun``).  Its keys are the reference's where they mean the
same thing: ``roofline``, ``collectives``, ``collective_counts``,
``model_flops``, ``useful_flops_ratio``, ``n_devices``,
``bytes_per_device_live`` and ``memory`` with ``argument_size_in_bytes``
(this rank's state and batch blocks; at a serve cell its param, cache
and batch blocks), ``output_size_in_bytes`` (the state and the metrics;
the caches and the logits), ``alias_size_in_bytes`` (the state, updated
in place; the caches at decode, which the reference donates, and 0 at
prefill) and ``temp_size_in_bytes`` (the peak of the live intermediates
the walker saw); ``lower_s`` is the trace's time.  ``stage_loops`` is the
walker's ``while_report``.  A prefill cell's ``whole_over_model`` names
what its step computes whole on every ``model`` rank
(:func:`whole_over_model`), the overcount in its ``useful_flops_ratio``.
With no counterpart, ``compile_s``,
``generated_code_size_in_bytes`` and ``xla_cost_analysis`` are left out.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from ..configs import ARCH_IDS, get_config
from ..distributed import hlo_cost
from ..distributed.axes import logical_axes
from ..distributed.hlo_analysis import roofline_from_step
from ..distributed.sharding import (batch_axes_for, batch_spec, shard_params,
                                    shard_state, shardings_of)
from ..models.config import ModelConfig
from ..models.model import abstract_cache, heads_cut_on
from ..models.quantized import quantize_serving_params
from ..optim.adamw import AdamWConfig
from ..serve.step import make_decode_step, make_prefill_step
from ..train.step import make_train_step
from ..tree import leaves
from .mesh import make_production_mesh
from .specs import (SHAPES, batch_specs, cell_skip_reason, input_specs,
                    model_flops_estimate)


def _opt_cfg(cfg: ModelConfig) -> AdamWConfig:
    # bf16 optimizer states for the 340B-class config (memory fit)
    sdt = "bfloat16" if cfg.param_count() > 1e11 else "float32"
    return AdamWConfig(state_dtype=sdt)


def _nbytes(tree) -> int:
    return sum(t.nelement() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def trace_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh, state,
                     batch):
    """Rank ``mesh.rank``'s SPMD train step on ``mesh`` (a
    ``CountingMesh``), traced by the step cost walker: ``state`` (whole,
    meta) cut by ``state_specs``, the global ``batch`` cut by
    ``batch_spec`` inside the step.  Returns (the walker's cost, whose
    ``result`` is the step's (state, metrics); the bytes of this rank's
    arguments, its state and batch blocks)."""
    local = shard_state(cfg, state, mesh, "meta")
    b_sh = shardings_of(batch_spec(cfg, batch, mesh), mesh)
    arg_bytes = _nbytes(local) + sum(
        _nbytes(b_sh[k].local(v)) for k, v in batch.items())
    with logical_axes(mesh, n_experts=cfg.n_experts):
        cost = hlo_cost.trace_step(make_train_step(cfg, opt_cfg), local,
                                   batch, mesh=mesh)
    return cost, arg_bytes


def _local(cfg: ModelConfig, batch, mesh):
    """This rank's blocks of a batch's leaves by ``batch_spec``."""
    sh = shardings_of(batch_spec(cfg, batch, mesh), mesh)
    return {k: sh[k].local(v) for k, v in batch.items()}


def trace_serve_step(cfg: ModelConfig, mesh, kind: str, B: int, S: int,
                     params):
    """Rank ``mesh.rank``'s serve step on ``mesh`` (a ``CountingMesh``),
    traced by the step cost walker: ``kind="prefill"`` the prefill of B
    prompts of S tokens into caches of S, ``"decode"`` one token of B
    sequences against caches of S at the last position.  ``params`` is
    the whole (meta) tree, cut by ``param_specs``; the caches are
    ``abstract_cache``'s blocks by ``cache_specs`` and the batch is cut
    by ``batch_spec``, inside ``logical_axes`` with the batch axes' cut.
    Returns (the walker's cost, whose ``result`` is the step's (logits,
    caches); the bytes of this rank's arguments; the bytes of its caches,
    which a decode step updates in place)."""
    blocks = shard_params(cfg, params, mesh, "meta")
    n_b = mesh.axis_size(batch_axes_for(mesh))
    with logical_axes(mesh, n_experts=cfg.n_experts,
                      batch_cut=B % n_b == 0):
        if kind == "prefill":
            batch = _local(cfg, batch_specs(cfg, B, S), mesh)
            args, caches = (blocks, batch), ()
            fn = make_prefill_step(cfg, S)
        else:
            caches = abstract_cache(cfg, B, S)
            token = _local(cfg, {"token": torch.empty(
                (B, 1), dtype=torch.int32, device="meta")}, mesh)["token"]
            args = (blocks, caches, token, S - 1)
            fn = make_decode_step(cfg)
        cost = hlo_cost.trace_step(fn, *args, mesh=mesh)
    return cost, _nbytes(args), _nbytes(caches)


def whole_over_model(cfg: ModelConfig, M: int) -> list:
    """What a prefill on a ``model`` axis M wide computes whole on every
    rank, each an overcount of its FLOPs beside one device's work cut M
    ways: attention whose query heads do not split over M
    (``models/model.py::heads_cut_on``; elsewhere each rank attends with
    its block of heads) and the RG-LRU and Mamba-2 scans, which run on the
    width their projections' blocks were gathered to (``rglru_forward``,
    ``mamba_forward``)."""
    if M == 1:
        return []
    kinds = {sp.kind for st in cfg.stages() for sp in st.period}
    out = []
    if (kinds & {"attn", "local"} or cfg.is_encdec) \
            and not heads_cut_on(cfg, M):
        out.append(f"attention ({cfg.n_heads} heads over {M})")
    out += [f"{k} scan" for k in ("rglru", "mamba") if k in kinds]
    return out


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               quantized: bool = False, overrides: dict = None) -> dict:
    """One cell's record (module doc).  A quantized train cell raises the
    reference's ``AssertionError`` (``main`` records it)."""
    cfg = get_config(arch)
    if quantized:
        cfg = dataclasses.replace(cfg, quantize_bits=8)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "multi" if multi_pod else "single",
           "quantized": quantized, "overrides": overrides or {},
           "ok": False}
    skip = cell_skip_reason(cfg, shape_name)
    if skip:
        rec.update(skipped=True, reason=skip, ok=True)
        return rec
    sh = SHAPES[shape_name]
    if quantized and sh["kind"] == "train":
        raise AssertionError("quantized path is serving-only")
    mesh = make_production_mesh(multi_pod=multi_pod, counting=True)
    n_dev = mesh.size
    t0 = time.time()
    if sh["kind"] == "train":
        opt_cfg = _opt_cfg(cfg)
        state, batch = input_specs(cfg, shape_name, opt_cfg)
        cost, arg_bytes = trace_train_step(cfg, opt_cfg, mesh, state, batch)
        local, metrics = cost.result
        out_bytes = alias = _nbytes(local)
        out_bytes += _nbytes(metrics)
    else:
        params = input_specs(cfg, shape_name)[0]
        if quantized:
            params = quantize_serving_params(params)
        cost, arg_bytes, cache_bytes = trace_serve_step(
            cfg, mesh, sh["kind"], sh["batch"], sh["seq"], params)
        out_bytes = _nbytes(cost.result)
        alias = cache_bytes
    t_lower = time.time() - t0
    mem_rec = {"argument_size_in_bytes": arg_bytes,
               "output_size_in_bytes": out_bytes,
               "temp_size_in_bytes": cost.peak_bytes,
               "alias_size_in_bytes": alias}
    live = (mem_rec["argument_size_in_bytes"]
            + mem_rec["output_size_in_bytes"]
            + mem_rec["temp_size_in_bytes"]
            - mem_rec["alias_size_in_bytes"])
    res = cost.report()
    rl = roofline_from_step(res, n_dev)
    mf = model_flops_estimate(cfg, shape_name)
    total_flops = rl.flops_per_device * n_dev
    rec.update(
        ok=True, skipped=False, n_devices=n_dev,
        lower_s=round(t_lower, 2), memory=mem_rec,
        bytes_per_device_live=int(live),
        roofline=rl.as_dict(),
        collectives=res["collectives"],
        collective_counts=res["collective_counts"],
        stage_loops=cost.while_report(), n_ops=cost.n_ops,
        model_flops=mf,
        useful_flops_ratio=mf / total_flops if total_flops else None,
    )
    if sh["kind"] == "prefill":
        rec["whole_over_model"] = whole_over_model(cfg, mesh.shape["model"])
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--quantized", action="store_true",
                    help="int8 weights (serving cells; a train cell is "
                         "refused)")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    torch.set_num_threads(1)          # meta tensors compute nothing
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'multi' if mp else 'single'}" + \
                    ("_q8" if args.quantized else "")
                path = out / f"{tag}.json"
                if path.exists():
                    print(f"[skip] {tag} (artifact exists)")
                    continue
                print(f"[cell] {tag} ...", flush=True)
                try:
                    rec = lower_cell(arch, shape, mp,
                                     quantized=args.quantized)
                except Exception as e:            # noqa: BLE001
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "ok": False, "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                path.write_text(json.dumps(rec, indent=1))
                if not rec.get("ok"):
                    n_fail += 1
                    print(f"   FAIL {rec['error']}")
                elif rec.get("skipped"):
                    print(f"   skipped: {rec['reason']}")
                else:
                    r = rec["roofline"]
                    print(f"   ok trace={rec['lower_s']}s "
                          f"bottleneck={r['bottleneck']} "
                          f"step={max(r['compute_s'], r['memory_s'], r['collective_s']):.4f}s "
                          f"mem/dev={rec['bytes_per_device_live']/1e9:.2f}GB")
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
