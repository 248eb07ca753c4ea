"""One rank of the spawned runs of ``test_torch_mesh_serve_dense.py``.

The parent bridges the reference's params to numpy, writes the inputs to
``inputs.pt`` and spawns one gloo group each of 2, 4 and 8 ranks with
:func:`run`.  Each rank joins its group through a file rendezvous (every
collective waits at most 60 s), runs every case of its group's size — each
case makes its own mesh over the group — and writes ``rank{r}.pt`` for the
parent to check.  This module imports torch, numpy and the port only, so
the ranks never load JAX.
"""
import copy
import datetime
import sys
import traceback
from pathlib import Path

import torch

#: decode steps after the prefill
N_DECODE = 4
#: the dense serve cases by group size: (id, input case, mesh axes, q8).
#: Every stack on 1x2 and 2x2 (batch 2: rows over ``data``, the sequence
#: over ``model``); batch 1 on 2x2 (the sequence over ``data x model``);
#: 2x1 and 4x1 (rows over ``data``, caches whole over their sequence); a
#: cache length ``model`` does not divide (whole caches, no combine);
#: whisper with 15 audio frames (``xk``/``xv`` whole) beside its 16 (cut);
#: int8 weights on 1x2 and 1x4; ``pod x data x model`` meshes: 2x1x2 at
#: batch 2 (rows over ``pod``) and 1 (the sequence over ``model`` alone),
#: and 2x2x2 at batch 1 and 2 (the sequence over the ``data x model``
#: group beside a wide ``pod``, which the batch axes' 4 do not divide)
CASES = {
    2: (
        ("qwen3-1x2", "qwen3-0.6b", {"data": 1, "model": 2}, False),
        ("gemma3-1x2", "gemma3-12b", {"data": 1, "model": 2}, False),
        ("recurrentgemma-1x2", "recurrentgemma-9b", {"data": 1, "model": 2},
         False),
        ("mamba2-1x2", "mamba2-1.3b", {"data": 1, "model": 2}, False),
        ("whisper-1x2", "whisper-small", {"data": 1, "model": 2}, False),
        ("whisper-f15-1x2", "whisper-f15", {"data": 1, "model": 2}, False),
        ("mixtral-1x2", "mixtral-8x7b", {"data": 1, "model": 2}, False),
        ("qwen3-2x1", "qwen3-0.6b", {"data": 2, "model": 1}, False),
        ("mixtral-2x1", "mixtral-8x7b", {"data": 2, "model": 1}, False),
        ("qwen3-len25-1x2", "qwen3-len25", {"data": 1, "model": 2}, False),
        ("qwen3-q8-1x2", "qwen3-0.6b", {"data": 1, "model": 2}, True),
    ),
    4: (
        ("qwen3-2x2", "qwen3-0.6b", {"data": 2, "model": 2}, False),
        ("gemma3-2x2", "gemma3-12b", {"data": 2, "model": 2}, False),
        ("recurrentgemma-2x2", "recurrentgemma-9b", {"data": 2, "model": 2},
         False),
        ("mamba2-2x2", "mamba2-1.3b", {"data": 2, "model": 2}, False),
        ("whisper-2x2", "whisper-small", {"data": 2, "model": 2}, False),
        ("mixtral-2x2", "mixtral-8x7b", {"data": 2, "model": 2}, False),
        ("qwen3-b1-2x2", "qwen3-b1", {"data": 2, "model": 2}, False),
        ("gemma3-b1-2x2", "gemma3-b1", {"data": 2, "model": 2}, False),
        ("whisper-b1-2x2", "whisper-b1", {"data": 2, "model": 2}, False),
        ("qwen3-1x4", "qwen3-0.6b", {"data": 1, "model": 4}, False),
        ("recurrentgemma-1x4", "recurrentgemma-9b", {"data": 1, "model": 4},
         False),
        ("mamba2-1x4", "mamba2-1.3b", {"data": 1, "model": 4}, False),
        ("mixtral-1x4", "mixtral-8x7b", {"data": 1, "model": 4}, False),
        ("qwen3-4x1", "qwen3-b4", {"data": 4, "model": 1}, False),
        ("qwen3-q8-1x4", "qwen3-0.6b", {"data": 1, "model": 4}, True),
        ("qwen3-2x1x2", "qwen3-0.6b", {"pod": 2, "data": 1, "model": 2},
         False),
        ("qwen3-b1-2x1x2", "qwen3-b1", {"pod": 2, "data": 1, "model": 2},
         False),
    ),
    8: (
        ("qwen3-b1-2x2x2", "qwen3-b1", {"pod": 2, "data": 2, "model": 2},
         False),
        ("qwen3-2x2x2", "qwen3-0.6b", {"pod": 2, "data": 2, "model": 2},
         False),
    ),
}
#: the engine with int8 weights on 1x2 against the unmeshed int8 engine:
#: (input case, prompts' length, new tokens)
ENGINE_Q8 = ("qwen3-0.6b", 6, 8)


def _collectives(mesh):
    return {k: dict(v) for k, v in mesh.collectives.items()}


def _params(case, q8):
    from repro_torch.models.model import params_from_numpy
    from repro_torch.models.quantized import quantize_serving_params
    params = params_from_numpy(copy.deepcopy(case["params"]), device="cpu")
    return quantize_serving_params(params) if q8 else params


def _clone(caches):
    from repro_torch.tree import tree_map
    return tree_map(torch.clone, list(caches))


def serve(case, mesh, q8):
    """The case's prefill then ``N_DECODE`` greedy decode steps on
    ``mesh``: this rank's blocks of the params, the batch and the caches
    (``make_prefill_step``/``make_decode_step`` inside ``logical_axes``).
    Returns the steps' logits and tokens (this rank's rows), the caches
    after the prefill and after the last step (this rank's blocks), and
    the collectives of the first decode step."""
    from repro_torch.distributed.axes import logical_axes
    from repro_torch.distributed.sharding import (batch_axes_for,
                                                  batch_spec, shard_params,
                                                  shardings_of)
    from repro_torch.serve.step import make_decode_step, make_prefill_step
    cfg = case["cfg"]
    params = _params(case, q8)
    if mesh.size > 1:
        params = shard_params(cfg, params, mesh, "cpu")
    whole = {k: torch.from_numpy(v.copy()) for k, v in case["batch"].items()}
    sh = shardings_of(batch_spec(cfg, whole, mesh), mesh)
    batch = {k: sh[k].local(v) for k, v in whole.items()}
    B = whole["tokens"].shape[0]
    n_b = mesh.axis_size(batch_axes_for(mesh))
    pos = case["pos"]
    with logical_axes(mesh, n_experts=cfg.n_experts,
                      batch_cut=B % n_b == 0):
        mesh.reset_collectives()
        logits, caches = make_prefill_step(cfg, case["max_len"])(params,
                                                                 batch)
        prefill_caches = _clone(caches)
        out = {"logits": [logits], "tokens": [logits.argmax(-1)]}
        step = make_decode_step(cfg)
        for i in range(N_DECODE):
            mesh.reset_collectives()
            logits, caches = step(params, caches,
                                  out["tokens"][-1].to(torch.int32), pos + i)
            if i == 0:
                out["collectives"] = _collectives(mesh)
            out["logits"].append(logits)
            out["tokens"].append(logits.argmax(-1))
    out["prefill_caches"] = prefill_caches
    out["caches"] = _clone(caches)
    out["is_blocks"] = type(caches).__name__
    return out


def _engine_q8(inputs, rank):
    """The int8 engine on a 1x2 mesh and, on rank 0, unmeshed: greedy
    tokens of each."""
    import _torch_mesh_worker as MW
    from repro_torch.launch.mesh import make_host_mesh
    name, _, max_new = ENGINE_Q8
    case = inputs[name]
    cfg, params = case["cfg"], _params(case, True)
    prompts = inputs["engine_prompts"]
    meshed, _ = MW._serve(MW._engine(cfg, params, make_host_mesh(1, 2)),
                          prompts, max_new, 4)
    plain = (MW._serve(MW._engine(cfg, params), prompts, max_new, 4)[0]
             if rank == 0 else None)
    return {"meshed": meshed, "plain": plain}


def cases(world, rank, inputs):
    from repro_torch.launch.mesh import make_host_mesh
    res = {"serve": {}}
    for cid, name, axes, q8 in CASES[world]:
        res["serve"][cid] = serve(inputs[name], make_host_mesh(axes=axes),
                                  q8)
    if world == 2:
        res["engine_q8"] = _engine_q8(inputs, rank)
    res["jax_loaded"] = any(m == "jax" or m.startswith(("jax.", "repro."))
                            or m == "repro" for m in sys.modules)
    return res


def run(rank: int, world: int, rdzv: str, in_path: str, out_dir: str):
    """A rank's whole life: join the group, run the cases, write
    ``rank{rank}.pt`` (or the traceback in ``rank{rank}.err``)."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    out = Path(out_dir)
    try:
        dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=60))
        inputs = torch.load(in_path, weights_only=False)
        res = cases(world, rank, inputs)
        torch.save(res, out / f"rank{rank}.tmp")
        (out / f"rank{rank}.tmp").rename(out / f"rank{rank}.pt")
    except BaseException:                          # noqa: BLE001
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
