"""One rank of the spawned runs of ``test_torch_mesh_serve_data.py``:
serving on meshes whose ``data`` axis is wider than 1.

The parent draws the port params, computes the reference's greedy tokens
and the unmeshed engine's step logits, writes them to ``inputs.pt`` and
spawns one process per mesh device with :func:`run`.  Each rank joins a
gloo group through a file rendezvous (no TCP port to collide between
test workers), runs every case of its world size inside that group (2
ranks: the 2x1 mesh; 4 ranks: 2x2 and 4x1), and writes ``rank{r}.pt``
for the parent to check.  This module imports torch, numpy and the port
only, so the ranks never load JAX.
"""
import dataclasses
import datetime
import sys
import traceback
from pathlib import Path

import torch

from _torch_mesh_worker import _collectives, _img_record, _serve, _strip

ARCHS = ("qwen3-0.6b", "gemma3-12b", "recurrentgemma-9b", "mamba2-1.3b",
         "mixtral-8x7b")
LAYOUTS = ("shard", "replicate")
HORIZONS = (1, 8)
#: the meshes of each world size, (data, model)
MESHES = {2: ((2, 1),), 4: ((2, 2), (4, 1))}
#: four slots, so that every ``data`` width here cuts them
POOL = dict(n_pages=33, page_size=8, max_seqs=4, max_pages_per_seq=8)
N_PROMPTS = 4
MAX_NEW = 16
#: the fallback: 3 slots on 2x1, which ``data`` does not divide
FALLBACK_SLOTS = 3
FALLBACK_ARCHS = ("qwen3-0.6b", "mixtral-8x7b")


def _engine(cfg, params, mesh=None, layout="shard", **kw):
    from repro_torch.serve.engine import PagedEngine
    args = dict(POOL)
    args.update(kw)
    return PagedEngine(cfg, params, device="cpu", attn_impl="gather",
                       mesh=mesh, kv_layout=layout, **args)


def step_logits(eng, prompts):
    """Prefill every prompt into its slot, then one decode step of every
    slot: the step's logits [max_seqs, vocab], the greedy tokens it fed,
    slot 0's block exported as a sealed image (prompt and fed token), and
    the collectives of the decode step alone."""
    alloc = eng.alloc
    L = max(len(p) for p in prompts)
    toks = torch.zeros((eng.max_seqs, L), dtype=torch.int32)
    n = torch.zeros((eng.max_seqs,), dtype=torch.int32)
    blocks = []
    for s, p in enumerate(prompts):
        blocks.append(alloc.alloc(s))
        alloc.reserve(blocks[-1], len(p) + 1)
        toks[s, :len(p)] = torch.tensor(p)
        n[s] = len(p)
    first = eng.prefill_chunk(toks, n)
    mask = torch.zeros((eng.max_seqs,), dtype=torch.bool)
    mask[:len(prompts)] = True
    if eng.mesh is not None:
        eng.mesh.reset_collectives()
    logits = eng.decode(first, mask)[:, 0]
    step = None if eng.mesh is None else _collectives(eng.mesh)
    alloc.commit(blocks[0], len(prompts[0]) + 1)
    img = alloc.export_image(blocks[0], tokens=list(prompts[0])
                             + [int(first[0])])
    for blk in list(alloc.blocks.values()):
        alloc.free(blk)
    return logits.clone(), first.tolist(), img, step


def _pools(eng):
    """Every leaf of the engine's serve state, copied."""
    return {f.name: getattr(eng.state, f.name).clone()
            for f in dataclasses.fields(eng.state)}


def _mesh_cases(mesh, inputs):
    """Every stack under both layouts and both horizons on ``mesh``."""
    from repro_torch.serve.telemetry import Telemetry
    label = tuple(mesh.shape.values())
    res = {"tokens": {}, "logits": {}, "images": {}, "pools": {}}
    for arch in ARCHS:
        cfg, params = inputs[arch]["cfg"], inputs[arch]["params"]
        prompts = inputs[arch]["prompts"]
        for layout in LAYOUTS:
            for k in HORIZONS:
                mesh.reset_collectives()
                telem = Telemetry(trace=True) if k == 8 else None
                eng = _engine(cfg, params, mesh, layout)
                out, sched = _serve(eng, prompts, MAX_NEW, k, telem)
                res["tokens"][(label, arch, layout, k)] = {
                    "out": out, "stats": dict(sched.stats),
                    "engine_stats": dict(eng.stats),
                    "free": (eng.free_pages, eng.alloc.free_pages),
                    "collectives": _collectives(mesh),
                    "trace": (None if telem is None
                              else _strip(telem.tracer.events)),
                    "placement": eng.placement,
                    "kv_layout": eng.kv_layout}
                if k == 8:
                    res["pools"][(label, arch, layout)] = _pools(eng)
            eng = _engine(cfg, params, mesh, layout)
            logits, first, own, step = step_logits(eng, prompts)
            res["logits"][(label, arch, layout)] = {
                "logits": logits, "first": first, "step": step}
            # the unmeshed pool's image of a block, imported into this
            # mesh's pool and exported again; and this pool's own image
            img0 = inputs[arch]["image"]
            eng = _engine(cfg, params, mesh, layout)
            blk = eng.alloc.import_image(img0, 1)
            back = eng.alloc.export_image(blk, tokens=img0.tokens)
            res["images"][(label, arch, layout)] = {
                "round_trip": _img_record(back), "own": _img_record(own)}
    return res


def _fallback(mesh, inputs):
    """3 slots on 2x1: ``data`` does not divide them, so every rank runs
    every slot; the MoE takes the local path."""
    out = {}
    for arch in FALLBACK_ARCHS:
        cfg, params = inputs[arch]["cfg"], inputs[arch]["params"]
        prompts = inputs[arch]["prompts"][:FALLBACK_SLOTS]
        mesh.reset_collectives()
        eng = _engine(cfg, params, mesh, "shard", max_seqs=FALLBACK_SLOTS)
        toks, _ = _serve(eng, prompts, MAX_NEW, 8)
        logits, _, _, step = step_logits(
            _engine(cfg, params, mesh, "shard", max_seqs=FALLBACK_SLOTS),
            prompts)
        out[arch] = {"out": toks, "logits": logits, "step": step,
                     "collectives": _collectives(mesh)}
    return out


def _pressure(mesh, inputs):
    """Preemption and the host swap tier on the 2x2 sharded pool
    (tests/test_mesh_serve.py:128-149 at two slots, one a ``data``
    rank)."""
    cfg, params = inputs["qwen3-0.6b"]["cfg"], inputs["qwen3-0.6b"]["params"]
    prompts = inputs["qwen3-0.6b"]["prompts"][:2]
    roomy, _ = _serve(_engine(cfg, params, mesh, "shard", n_pages=33,
                              page_size=4, max_seqs=2), prompts, 12, 4)
    tight = dict(n_pages=8, page_size=4, max_seqs=2)
    discard, s_d = _serve(_engine(cfg, params, mesh, "shard", **tight),
                          prompts, 12, 4)
    eng = _engine(cfg, params, mesh, "shard", host_swap_pages=32, **tight)
    swapped, s_s = _serve(eng, prompts, 12, 4)
    return {"roomy": roomy, "discard": discard, "swapped": swapped,
            "preemptions": s_d.stats["preemptions"],
            "swap_ins": s_s.stats["swap_ins"],
            "tier_used": eng.alloc.swap.used_pages,
            "free": (eng.free_pages, eng.alloc.free_pages)}


def _launcher(shape):
    """The launcher through ``main`` on this group with ``--mesh-shape``
    ``shape``, with and without ``--disagg``, beside the same run without
    a mesh."""
    from repro_torch import tree
    from repro_torch.distributed.sharding import ParamBlocks
    from repro_torch.launch import serve
    base = ["--device", "cpu", "--requests", "4", "--max-new", "8",
            "--prompt-len", "5"]
    out = {}
    for name, extra in (("unified", []), ("disagg", ["--disagg"])):
        fin, eng, sched = serve.main(base + extra + [
            "--mesh-shape", shape, "--kv-layout", "shard"])
        plain, p_eng, _ = serve.main(base + extra)
        engines = [eng] + ([sched.prefill.engine] if extra else [])
        out[name] = {"mesh": {r.rid: list(r.out) for r in fin},
                     "plain": {r.rid: list(r.out) for r in plain},
                     "param_bytes": sum(t.nbytes
                                        for t in tree.leaves(eng.params)),
                     "whole_bytes": sum(t.nbytes
                                        for t in tree.leaves(p_eng.params)),
                     "blocks": isinstance(eng.params, ParamBlocks),
                     "one_tree": all(e.params is eng.params
                                     for e in engines),
                     "attn_impl": eng.attn_impl,
                     "collectives": _collectives(eng.mesh)}
    return out


def cases(world, inputs):
    """Every case of one world size, on this rank: the results dict."""
    from repro_torch.launch.mesh import make_host_mesh
    res = {"coords": {}, "meshes": {}}
    for data, model in MESHES[world]:
        mesh = make_host_mesh(data, model)
        res["coords"][(data, model)] = dict(mesh.coords)
        res["meshes"][(data, model)] = _mesh_cases(mesh, inputs)
        if (data, model) == (2, 1):
            res["fallback"] = _fallback(mesh, inputs)
        if (data, model) == (2, 2):
            res["pressure"] = _pressure(mesh, inputs)
    res["launcher"] = _launcher("2x1" if world == 2 else "2x2")
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
        res = cases(world, inputs)
        torch.save(res, out / f"rank{rank}.tmp")
        (out / f"rank{rank}.tmp").rename(out / f"rank{rank}.pt")
    except BaseException:                          # noqa: BLE001
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_nccl(rank: int, world: int, rdzv: str, out_dir: str):
    """A rank of the card test of a ``world x 1`` mesh over nccl (one card
    per rank): the qwen3 and mixtral smoke serves on the mesh (each rank
    its block of 4 slots) and unmeshed, their tokens and the mesh's
    collectives in ``rank{rank}.pt``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import serve_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import PagedEngine
    out = Path(out_dir)
    try:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        dist.init_process_group("nccl", init_method=f"file://{rdzv}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=60))
        prompts = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3], [2, 7, 1, 8, 2],
                   [8, 1, 8, 2, 8]]
        mesh = make_host_mesh(world, 1, device="cuda")
        res = {}
        for arch in ("qwen3-0.6b", "mixtral-8x7b"):
            cfg = serve_config(arch)
            params = init_params(cfg, seed=0, device=dev)
            res[arch] = {}
            for name, m, impl in (("mesh", mesh, "gather"),
                                  ("plain", None, "kernel")):
                eng = PagedEngine(cfg, params, device=dev, attn_impl=impl,
                                  mesh=m, kv_layout="shard", **POOL)
                res[arch][name], _ = _serve(eng, prompts, MAX_NEW, 8)
            res[arch]["collectives"] = _collectives(mesh)
            mesh.reset_collectives()
        torch.save(res, out / f"rank{rank}.pt")
    except BaseException:                          # noqa: BLE001
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
