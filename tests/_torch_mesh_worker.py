"""One rank of the spawned mesh-serving runs of ``test_torch_mesh_serve.py``.

The parent bridges the reference's params to the port and computes the
reference's greedy tokens; it writes the port params and the prompts to
``inputs.pt`` and spawns one process per mesh device with
:func:`run`.  Each rank joins a gloo group through a file rendezvous
(no TCP port to collide between test workers), runs every case of its
world size inside one process group, and writes ``rank{r}.pt`` for the
parent to check.  This module imports torch, numpy and the port only, so
the ranks never load JAX.
"""
import dataclasses
import datetime
import sys
import traceback
from pathlib import Path

import torch

ARCHS = ("qwen3-0.6b", "gemma3-12b", "recurrentgemma-9b", "mamba2-1.3b",
         "mixtral-8x7b", "qwen3-moe-235b-a22b")
#: the MoE stacks among them (expert-parallel on the mesh)
MOE_ARCHS = ("mixtral-8x7b", "qwen3-moe-235b-a22b")
#: (B, S) of the moe_ep cases at one token per sequence
#: (tests/test_mesh_serve.py::test_moe_ep_T1_matches_dense_bitexact)
T1_SHAPES = ((1, 1), (2, 1), (4, 1))
LAYOUTS = ("shard", "replicate")
HORIZONS = (1, 8)
#: the reference's pool and scheduler settings (tests/test_mesh_serve.py)
POOL = dict(n_pages=33, page_size=8, max_seqs=2, max_pages_per_seq=8)
MAX_NEW = 16


def _engine(cfg, params, mesh=None, layout="shard", **kw):
    from repro_torch.serve.engine import PagedEngine
    args = dict(POOL)
    args.update(kw)
    return PagedEngine(cfg, params, device="cpu", attn_impl="gather",
                       mesh=mesh, kv_layout=layout, **args)


def _serve(eng, prompts, max_new, k, telemetry=None):
    from repro_torch.serve.scheduler import Scheduler
    sched = Scheduler(eng, prefill_chunk=4, decode_horizon=k,
                      telemetry=telemetry)
    for p in prompts:
        sched.add_request(p, max_new=max_new)
    fin = sched.run()
    return {r.rid: list(r.out) for r in fin}, sched


def _step_logits(eng, prompts):
    """Prefill every prompt into its slot, then one decode step: the
    step's logits [max_seqs, vocab], the greedy tokens it fed, slot 0's
    block exported as a sealed image (prompt and fed token), and the
    collectives of the decode step alone (None without a mesh)."""
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


def _img_record(img):
    return {"k": img.k.copy(), "v": img.v.copy(),
            "aux": None if img.aux is None else [a.copy() for a in img.aux],
            "checksum": img.checksum, "n_pages": img.n_pages}


def _local_shapes(eng):
    return {f.name: tuple(getattr(eng.state, f.name).shape)
            for f in dataclasses.fields(eng.state)}


def _collectives(mesh):
    return {k: dict(v) for k, v in mesh.collectives.items()}


def _strip(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "sync")}
            for e in events]


def _refusals(world, mesh, inputs):
    """Each refusal: (exception class name, message)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.engine import PagedEngine
    cfg, params = inputs["qwen3-0.6b"]["cfg"], inputs["qwen3-0.6b"]["params"]
    out = {}

    def catch(name, fn):
        try:
            fn()
            out[name] = (None, "")
        except Exception as e:                    # noqa: BLE001
            out[name] = (type(e).__name__, str(e))

    catch("kernel", lambda: PagedEngine(
        cfg, params, n_pages=9, page_size=8, max_seqs=1, device="cpu",
        attn_impl="kernel", mesh=mesh, kv_layout="shard"))
    data_mesh = make_host_mesh(data=world, model=1)
    catch("data", lambda: PagedEngine(
        cfg, params, n_pages=9, page_size=8, max_seqs=1, device="cpu",
        attn_impl="kernel", mesh=data_mesh, kv_layout="shard"))
    return out


def _moe_cases(world, mesh, inputs):
    """``moe_ep`` on this group beside the port's local ``moe`` on the
    same weights and inputs, each call's collectives recorded: the
    mixtral smoke MoE at one token per sequence (EP), and on 4 ranks the
    TP fallback (6 experts over 4) and a 2x2 ``data x model`` mesh (each
    rank feeds its ``data`` block)."""
    from repro_torch.distributed.moe_ep import ep_capacity, moe_ep
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import moe
    m = inputs["moe"]
    out = {}

    def call(name, case, mesh, x):
        mesh.reset_collectives()
        out[name] = {"ep": moe_ep(case["params"], x, case["cfg"], mesh),
                     "collectives": _collectives(mesh),
                     "local": moe(case["params"], x, case["cfg"])}

    for B, S in T1_SHAPES:
        call(("t1", B, S), m["t1"], mesh, m["t1"]["x"][(B, S)])
        out[("t1", B, S)]["cap"] = ep_capacity(m["t1"]["cfg"], mesh, B, S)
    if world == 4:
        call("tp", m["tp"], mesh, m["tp"]["x"])
        grid = make_host_mesh(2, 2)
        x = m["data"]["x"]
        n = x.shape[0] // 2
        blk = x[grid.coords["data"] * n:(grid.coords["data"] + 1) * n]
        call("data", m["data"], grid, blk)
        out["data"]["coords"] = dict(grid.coords)
    return out


def _launcher(world):
    """The launcher through ``main`` on this group, with and without
    ``--disagg``, beside the same run without a mesh."""
    from repro_torch import tree
    from repro_torch.distributed.sharding import ParamBlocks
    from repro_torch.launch import serve
    base = ["--device", "cpu", "--requests", "4", "--max-new", "8",
            "--prompt-len", "5"]
    out = {}
    for name, extra in (("unified", []), ("disagg", ["--disagg"])):
        fin, eng, sched = serve.main(base + extra + [
            "--mesh-shape", f"1x{world}", "--kv-layout", "shard"])
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
                     "kv_layout": eng.kv_layout,
                     "placement": eng.placement,
                     "collectives": _collectives(eng.mesh)}
    return out


def cases(world, inputs):
    """Every case of one world size, on this rank: the results dict."""
    from repro_torch.core.vbi.address_space import VBProps
    from repro_torch.distributed.sharding import serve_state_specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.telemetry import Telemetry

    mesh = make_host_mesh(data=1, model=world)
    res = {"tokens": {}, "logits": {}, "shapes": {}, "images": {},
           "auto": {}}
    for arch in ARCHS:
        cfg, params = inputs[arch]["cfg"], inputs[arch]["params"]
        prompts = inputs[arch]["prompts"]
        plain_logits, plain_first, img0, _ = _step_logits(
            _engine(cfg, params), prompts)
        for layout in LAYOUTS:
            for k in HORIZONS:
                mesh.reset_collectives()
                telem = Telemetry(trace=True) if k == 8 else None
                eng = _engine(cfg, params, mesh, layout)
                out, sched = _serve(eng, prompts, MAX_NEW, k, telem)
                res["tokens"][(arch, layout, k)] = {
                    "out": out, "stats": dict(sched.stats),
                    "engine_stats": dict(eng.stats),
                    "free": (eng.free_pages, eng.alloc.free_pages),
                    "collectives": _collectives(mesh),
                    "trace": (None if telem is None
                              else _strip(telem.tracer.events)),
                    "placement": eng.placement,
                    "kv_layout": eng.kv_layout}
            eng = _engine(cfg, params, mesh, layout)
            logits, first, own, step = _step_logits(eng, prompts)
            res["logits"][(arch, layout)] = {
                "err": float((logits - plain_logits).abs().max()),
                "first": first, "plain_first": plain_first,
                "logits": logits, "step": step}
            res["shapes"][(arch, layout)] = {
                "local": _local_shapes(eng),
                "whole": _local_shapes(_engine(cfg, params)),
                "specs": {k: tuple(v) for k, v in serve_state_specs(
                    _engine(cfg, params).state, mesh, layout).items()}}
            # the unmeshed pool's image of a block, imported into the
            # sharded pool and exported again; and the sharded pool's own
            # image of the same block
            eng = _engine(cfg, params, mesh, layout)
            blk = eng.alloc.import_image(img0, 1)
            back = eng.alloc.export_image(blk, tokens=img0.tokens)
            res["images"][(arch, layout)] = {
                "plain": _img_record(img0), "round_trip": _img_record(back),
                "own": _img_record(own)}
        # kv_layout="auto": the layout its traced token steps count fewer
        # collective bytes for, chosen with no collective of the mesh's
        mesh.reset_collectives()
        eng = _engine(cfg, params, mesh, "auto")
        res["auto"][arch] = {"kv_layout": eng.kv_layout,
                             "report": eng.layout_report,
                             "collectives": _collectives(mesh)}
    cfg, params = inputs["qwen3-0.6b"]["cfg"], inputs["qwen3-0.6b"]["params"]
    prompts = inputs["qwen3-0.6b"]["prompts"]
    if world == 4:
        # pool pressure on the 1x4 sharded pool
        # (tests/test_mesh_serve.py:128-149)
        roomy, _ = _serve(_engine(cfg, params, mesh, "shard", n_pages=33,
                                  page_size=4), prompts, 12, 4)
        tight = dict(n_pages=8, page_size=4)
        discard, s_d = _serve(_engine(cfg, params, mesh, "shard", **tight),
                              prompts, 12, 4)
        eng = _engine(cfg, params, mesh, "shard", host_swap_pages=32,
                      **tight)
        swapped, s_s = _serve(eng, prompts, 12, 4)
        res["pressure"] = {
            "roomy": roomy, "discard": discard, "swapped": swapped,
            "preemptions": s_d.stats["preemptions"],
            "swap_ins": s_s.stats["swap_ins"],
            "tier_used": eng.alloc.swap.used_pages,
            "free": (eng.free_pages, eng.alloc.free_pages)}
    # placement is a block property
    eng = _engine(cfg, params, mesh, "shard", n_pages=17)
    blk = eng.alloc.alloc(0)
    res["placement"] = {"block": blk.placement, "engine": eng.placement,
                        "sharded": bool(blk.props & VBProps.SHARDED)}
    eng.alloc.free(blk)
    res["refusals"] = _refusals(world, mesh, inputs)
    res["moe"] = _moe_cases(world, mesh, inputs)
    # the mesh's own helpers: broadcast from axis index 0, constrain's
    # gather and slice, each counted
    from repro_torch.distributed.axes import constrain, logical_axes
    mesh.reset_collectives()
    x = torch.full((3,), float(mesh.rank))
    mesh.broadcast(x, src=0)
    blk = torch.arange(4.0) + 4 * mesh.rank
    with logical_axes(mesh):
        whole = constrain(blk, None, whole=(4 * world,))
        back = constrain(whole, "model")
    res["helpers"] = {"broadcast": x.tolist(), "whole": whole.tolist(),
                      "back": torch.equal(back, blk),
                      "collectives": _collectives(mesh)}
    if world == 2:
        res["launcher"] = _launcher(world)
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
    """A rank of the card test of a 1x``world`` mesh over nccl (one card
    per rank): the qwen3 and mixtral (expert-parallel) smoke serves meshed
    and unmeshed, their tokens in ``rank{rank}.pt``."""
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
        prompts = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]]
        mesh = make_host_mesh(1, world, device="cuda")
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
            res[arch]["all_to_all"] = mesh.collectives["all_to_all"]["calls"]
            mesh.reset_collectives()
        torch.save(res, out / f"rank{rank}.pt")
    except BaseException:                          # noqa: BLE001
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
