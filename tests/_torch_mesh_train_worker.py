"""One rank of the spawned mesh-training runs of ``test_torch_mesh_train.py``.

The parent bridges the reference's params to numpy and computes the
reference's single-device steps; it writes the inputs to ``inputs.pt`` and
spawns one process per mesh device with :func:`run`.  The ranks join one
gloo group of 4 through a file rendezvous (no TCP port to collide between
test workers; every collective waits at most 60 s), run every case in it
— each case makes its own mesh over the group — and write ``rank{r}.pt``
for the parent to check.  This module imports torch, numpy and the port
only, so the ranks never load JAX.
"""
import copy
import dataclasses
import datetime
import sys
import traceback
from pathlib import Path

import torch

WORLD = 4
#: the sharded-step matrix: mesh shapes, grad_accum, remat
SHAPES = ((2, 2), (1, 4), (4, 1))
ACCUMS = (1, 2)
REMATS = (False, True)
#: the stacks run on 2x2 beside the reference's dense config
EXTRA = ("qwen3-0.6b", "gemma3-12b", "bf16", "bf16_params")
#: meshes with a ``pod`` axis: (axes, fsdp_axes) — FSDP over pod x data
#: together, over data with the leaves replicated over pod, and a batch
#: over pod alone beside a ``model`` axis
POD_CASES = (({"pod": 2, "data": 2}, "pod_data"),
             ({"pod": 2, "data": 2}, "data"),
             ({"pod": 2, "model": 2}, "data"))
#: steps of the replicated-leaf case
REPLICATED_STEPS = 2


def _state(case):
    """A fresh port train state (CPU tensors) of a case's params."""
    from repro_torch.models.model import params_from_numpy
    from repro_torch.optim.adamw import init_opt_state
    params = params_from_numpy(copy.deepcopy(case["params"]), device="cpu")
    return {"params": params, "opt": init_opt_state(params, case["opt"])}


def _batch(case):
    return {k: torch.from_numpy(v.copy()) for k, v in case["batch"].items()}


def _collectives(mesh):
    return {k: dict(v) for k, v in mesh.collectives.items()}


def _step(case, mesh, cfg=None, n_steps=1, compress=None):
    """``n_steps`` of the SPMD step on ``mesh`` from the case's state:
    (this rank's state, metrics of the last step as floats, the state
    whole, the last step's collectives)."""
    from repro_torch import tree
    from repro_torch.distributed.axes import logical_axes
    from repro_torch.distributed.sharding import (shard_state, shardings_of,
                                                  state_specs)
    from repro_torch.train.step import make_train_step
    cfg = cfg or case["cfg"]
    whole = _state(case)
    sh = shardings_of(state_specs(cfg, whole, mesh), mesh)
    st = shard_state(cfg, whole, mesh, "cpu")
    with logical_axes(mesh):
        step = make_train_step(cfg, case["opt"], compress=compress)
        for _ in range(n_steps):
            mesh.reset_collectives()
            st, m = step(st, _batch(case))
        coll = _collectives(mesh)
        gathered = tree.map_with_path(lambda _, x, s: s.whole(x), st, sh)
    return st, {k: float(v) for k, v in m.items()}, gathered, coll


def _matrix(inputs, rank):
    """The reference's dense config on every mesh shape, accum and remat;
    the whole state comes back from rank 0 only."""
    from repro_torch.launch.mesh import make_host_mesh
    case = inputs["dense"]
    out = {}
    for shape in SHAPES:
        mesh = make_host_mesh(*shape)
        for accum in ACCUMS:
            for remat in REMATS:
                cfg = dataclasses.replace(case["cfg"], grad_accum=accum,
                                          remat=remat)
                _, m, whole, coll = _step(case, mesh, cfg)
                out[(shape, accum, remat)] = {
                    "metrics": m, "collectives": coll,
                    "state": whole if rank == 0 else None}
    return out


def _extra(inputs, rank):
    """qwen3 (qk-norm, tied embeddings) and gemma3 (local and global
    layers) smoke stacks at float32 compute, the reference's dense config
    at its own bfloat16 compute, and the dense config with
    ``bf16_params_in_compute`` at float32 compute, on 2x2."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(2, 2)
    out = {}
    for name in EXTRA:
        _, m, whole, coll = _step(inputs[name], mesh)
        out[name] = {"metrics": m, "collectives": coll,
                     "state": whole if rank == 0 else None}
    return out


def _pod(inputs, rank):
    """The dense config on the ``POD_CASES`` meshes."""
    from repro_torch.launch.mesh import make_host_mesh
    case = inputs["dense"]
    out = {}
    for i, (axes, fsdp) in enumerate(POD_CASES):
        mesh = make_host_mesh(axes=axes)
        cfg = dataclasses.replace(case["cfg"], fsdp_axes=fsdp)
        _, m, whole, coll = _step(case, mesh, cfg)
        out[i] = {"metrics": m, "collectives": coll,
                  "state": whole if rank == 0 else None}
    return out


def _replicated(inputs):
    """Two steps on 2x2: every leaf's block as this rank holds it, and
    this rank's coordinates, for the parent to compare across ranks."""
    from repro_torch import tree
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(2, 2)
    st, m, _, _ = _step(inputs["dense"], mesh, n_steps=REPLICATED_STEPS)
    return {"coords": dict(mesh.coords), "metrics": m,
            "leaves": tree.leaves_with_path(st)}


def _compressed(inputs, rank):
    """``compressed_psum`` over a 4-wide ``pod`` axis on row ``rank`` of
    the parent's matrix; one train step with the EF compressor (built on
    the params' shardings) on 2x2."""
    from repro_torch.distributed.compression import (compressed_psum,
                                                     make_ef_compressor)
    from repro_torch.distributed.sharding import param_specs, shardings_of
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import params_shape
    pod = make_host_mesh(axes={"pod": WORLD})
    x = torch.from_numpy(inputs["psum_x"][rank].copy())
    psum = compressed_psum(x, pod, "pod")
    psum_coll = _collectives(pod)
    case = inputs["dense"]
    mesh = make_host_mesh(2, 2)
    p_sh = shardings_of(param_specs(case["cfg"], params_shape(case["cfg"]),
                                    mesh), mesh)
    compress, init = make_ef_compressor(shardings=p_sh)
    ef = {}

    def hook(grads):
        if "ef" not in ef:
            ef["ef"] = init(grads)
        deq, ef["ef"] = compress(grads, ef["ef"])
        return deq

    _, m, whole, _ = _step(case, mesh, compress=hook)
    return {"psum": psum, "psum_collectives": psum_coll, "metrics": m,
            "state": whole if rank == 0 else None}


def _pipeline(inputs):
    """``pipeline_apply`` of ``tanh(h @ w)`` over a 4-stage ``pipe`` axis,
    each rank holding only its stage's weight."""
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.distributed.sharding import Sharding, Spec
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(axes={"pipe": WORLD})
    ws = torch.from_numpy(inputs["pipe_w"].copy())
    mine = Sharding(mesh, Spec("pipe", None, None)).local(ws).clone()
    out = pipeline_apply(lambda w, h: torch.tanh(h @ w), mine,
                         torch.from_numpy(inputs["pipe_x"].copy()), mesh)
    return {"out": out, "held": tuple(mine.shape),
            "collectives": _collectives(mesh)}


def _elastic(inputs, ckpt_dir):
    """A 2x2 state (after one step) saved whole, restored onto 1x4, 4x1
    and 2x2 and gathered whole again."""
    from repro_torch import tree
    from repro_torch.checkpoint import restore_pytree, save_pytree
    from repro_torch.distributed.sharding import (shard_state, shardings_of,
                                                  state_specs)
    from repro_torch.launch.mesh import make_host_mesh
    case = inputs["dense"]
    cfg = case["cfg"]
    mesh = make_host_mesh(2, 2)
    st, _, saved, _ = _step(case, mesh)
    save_pytree(st, ckpt_dir, 1, shardings=shardings_of(
        state_specs(cfg, saved, mesh), mesh))
    out = {"saved": saved, "restored": {}}
    for shape in ((1, 4), (4, 1), (2, 2)):
        m = make_host_mesh(*shape)
        sh = shardings_of(state_specs(cfg, saved, m), m)
        template = shard_state(cfg, _state(case), m, "cpu")
        got = restore_pytree(template, ckpt_dir, 1, shardings=sh)
        out["restored"][shape] = tree.map_with_path(
            lambda _, x, s: s.whole(x), got, sh)
    return out


def _loop(inputs, rank, ckpt_dir):
    """``TrainLoop`` on 2x2 with a sharded ``CheckpointManager``: rank 1
    alone sees a preemption notice during step 1; the ranks agree on it,
    all save step 1 (a collective) and stop."""
    from repro_torch.checkpoint import CheckpointManager, latest_step
    from repro_torch.distributed.axes import logical_axes
    from repro_torch.distributed.sharding import (shard_state, shardings_of,
                                                  state_specs)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.loop import TrainLoop
    from repro_torch.train.step import make_train_step
    case = inputs["dense"]
    cfg = case["cfg"]
    mesh = make_host_mesh(2, 2)
    whole = _state(case)
    sh = shardings_of(state_specs(cfg, whole, mesh), mesh)
    step_fn = make_train_step(cfg, case["opt"])
    box = {}

    def step(state, batch):
        out = step_fn(state, {k: torch.from_numpy(v) for k, v in
                              batch.items()})
        if rank == 1:
            box["loop"]._preempted = True
        return out

    loop = TrainLoop(step, lambda i: case["batch"],
                     CheckpointManager(ckpt_dir, shardings=sh),
                     ckpt_every=4, mesh=mesh)
    box["loop"] = loop
    with logical_axes(mesh):
        _, end, losses = loop.run(shard_state(cfg, whole, mesh, "cpu"), 0,
                                  6)
    return {"end": end, "losses": losses.tolist(),
            "latest": latest_step(ckpt_dir)}


def cases(rank, inputs, ckpt_dir):
    res = {"matrix": _matrix(inputs, rank), "extra": _extra(inputs, rank),
           "pod": _pod(inputs, rank),
           "replicated": _replicated(inputs),
           "compressed": _compressed(inputs, rank),
           "pipeline": _pipeline(inputs),
           "elastic": _elastic(inputs, ckpt_dir),
           "loop": _loop(inputs, rank, f"{ckpt_dir}_loop")}
    res["jax_loaded"] = any(m == "jax" or m.startswith(("jax.", "repro."))
                            or m == "repro" for m in sys.modules)
    return res


def run(rank: int, world: int, rdzv: str, in_path: str, out_dir: str,
        ckpt_dir: str):
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
        res = cases(rank, inputs, ckpt_dir)
        torch.save(res, out / f"rank{rank}.tmp")
        (out / f"rank{rank}.tmp").rename(out / f"rank{rank}.pt")
    except BaseException:                          # noqa: BLE001
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
