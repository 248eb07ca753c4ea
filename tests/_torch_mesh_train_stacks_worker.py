"""One rank of the spawned runs of ``test_torch_mesh_train_stacks.py``.

The parent bridges the reference's params to numpy, computes the
reference's single-device steps and MoE forwards, writes the inputs to
``inputs.pt`` and spawns one process per mesh device with :func:`run`.
The ranks join one gloo group of 4 through a file rendezvous (every
collective waits at most 60 s), run every case in it — each case makes
its own mesh over the group — and write ``rank{r}.pt`` for the parent to
check.  This module imports torch, numpy and the port only, so the ranks
never load JAX.
"""
import copy
import dataclasses
import datetime
import sys
import traceback
from pathlib import Path

import torch

WORLD = 4
#: the step cases: (id, input case, mesh axes, remat, fsdp_axes).  The
#: MoE on 2x2, 1x4 (EP) and 4x1, its 6-expert variant on 1x4 (the TP
#: fallback), EP with a sequence that does not split over ``model``
#: (S 30), a batch the batch ranks do not divide (B 5: the local path
#: with the experts gathered whole), the MoE on ``pod x data`` with FSDP
#: over both, the other stacks and RG-LRU with ``rnn_width`` 96 on 2x2
STEP_CASES = (
    ("moe-2x2", "moe", {"data": 2, "model": 2}, True, "data"),
    ("moe-1x4", "moe", {"data": 1, "model": 4}, False, "data"),
    ("moe-4x1", "moe", {"data": 4, "model": 1}, False, "data"),
    ("moe6-1x4", "moe6", {"data": 1, "model": 4}, False, "data"),
    ("moe-s30-1x4", "moe_s30", {"data": 1, "model": 4}, False, "data"),
    ("moe-b5-2x2", "moe_b5", {"data": 2, "model": 2}, True, "data"),
    ("moe-pod_data", "moe", {"pod": 2, "data": 2}, False, "pod_data"),
    ("recurrentgemma-2x2", "recurrentgemma-9b", {"data": 2, "model": 2},
     True, "data"),
    ("mamba2-2x2", "mamba2-1.3b", {"data": 2, "model": 2}, True, "data"),
    ("whisper-2x2", "whisper-small", {"data": 2, "model": 2}, True, "data"),
    ("internvl2-2x2", "internvl2-26b", {"data": 2, "model": 2}, True,
     "data"),
    ("rglru-w96-2x2", "rglru_w96", {"data": 2, "model": 2}, True, "data"),
)
#: the MoE forwards with drops: (id, input case, mesh axes)
DROP_CASES = (
    ("moe-2x2", "moe", {"data": 2, "model": 2}),
    ("moe-1x4", "moe", {"data": 1, "model": 4}),
    ("moe6-1x4", "moe6", {"data": 1, "model": 4}),
)


def _state(case):
    """A fresh port train state (CPU tensors) of a case's params."""
    from repro_torch.models.model import params_from_numpy
    from repro_torch.optim.adamw import init_opt_state
    params = params_from_numpy(copy.deepcopy(case["params"]), device="cpu")
    return {"params": params, "opt": init_opt_state(params, case["opt"])}


def _collectives(mesh):
    return {k: dict(v) for k, v in mesh.collectives.items()}


def _step(case, mesh, cfg):
    """One SPMD step on ``mesh``: (metrics as floats, the state whole,
    the step's collectives)."""
    from repro_torch import tree
    from repro_torch.distributed.axes import logical_axes
    from repro_torch.distributed.sharding import (shard_state, shardings_of,
                                                  state_specs)
    from repro_torch.train.step import make_train_step
    whole = _state(case)
    sh = shardings_of(state_specs(cfg, whole, mesh), mesh)
    st = shard_state(cfg, whole, mesh, "cpu")
    batch = {k: torch.from_numpy(v.copy()) for k, v in case["batch"].items()}
    with logical_axes(mesh, n_experts=cfg.n_experts):
        mesh.reset_collectives()
        st, m = make_train_step(cfg, case["opt"])(st, batch)
        coll = _collectives(mesh)
        gathered = tree.map_with_path(lambda _, x, s: s.whole(x), st, sh)
    return {k: float(v) for k, v in m.items()}, gathered, coll


def _steps(inputs, rank):
    """Every ``STEP_CASES`` step; the whole state comes back from rank 0
    only."""
    from repro_torch.launch.mesh import make_host_mesh
    out = {}
    for cid, name, axes, remat, fsdp in STEP_CASES:
        case = inputs[name]
        cfg = dataclasses.replace(case["cfg"], remat=remat, fsdp_axes=fsdp)
        mesh = make_host_mesh(axes=axes)
        m, whole, coll = _step(case, mesh, cfg)
        out[cid] = {"metrics": m, "collectives": coll,
                    "state": whole if rank == 0 else None}
    return out


def _drops(inputs):
    """The first MoE layer of each ``DROP_CASES`` input at its config's
    own ``capacity_factor``, forward only, under the train step's scope:
    this rank's params blocks, its FSDP blocks gathered by
    ``fsdp_layer``, ``moe`` on this rank's batch block of the parent's
    ``x``; returns the output (this rank's batch block, whole over
    ``model``)."""
    from repro_torch.distributed.axes import logical_axes, spmd_train
    from repro_torch.distributed.sharding import (Sharding, Spec,
                                                  param_specs, shard_params)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import moe
    from repro_torch.models.model import params_from_numpy, params_shape
    from repro_torch.models.tp import fsdp_layer
    out = {}
    for cid, name, axes in DROP_CASES:
        case = inputs[name]
        cfg = case["drop_cfg"]
        mesh = make_host_mesh(axes=axes)
        whole = params_from_numpy(copy.deepcopy(case["params"]), "cpu")
        blocks = shard_params(cfg, whole, mesh, "cpu")
        specs = param_specs(cfg, params_shape(cfg), mesh)
        si, pi = case["moe_at"]
        layer = {k: v[0] for k, v in blocks["stages"][si][pi]["moe"].items()}
        x = torch.from_numpy(case["drop_x"].copy())
        x = Sharding(mesh, Spec("data", None, None)).local(x)
        with logical_axes(mesh, n_experts=cfg.n_experts), spmd_train(mesh):
            p = fsdp_layer({"moe": layer},
                           {"moe": specs["stages"][si][pi]["moe"]}, cfg)
            out[cid] = {"y": moe(p["moe"], x, cfg).detach()}
    return out


def cases(rank, inputs):
    res = {"steps": _steps(inputs, rank), "drops": _drops(inputs)}
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
        res = cases(rank, inputs)
        torch.save(res, out / f"rank{rank}.tmp")
        (out / f"rank{rank}.tmp").rename(out / f"rank{rank}.pt")
    except BaseException:                          # noqa: BLE001
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
