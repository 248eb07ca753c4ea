"""The SPMD train step on device meshes, one process per device, beside
the unmeshed step on the same params and batches.

    PYTHONPATH=src torchrun --nproc-per-node 4 \\
        -m repro_torch.examples.train_mesh --device cpu [--arch ARCH]

The step runs on every ``data x model`` mesh of the world's size (1x4,
2x2 and 4x1 on four processes), 3 steps of 8 x 32 each.  Every rank
draws the smoke params of ``--arch`` (any architecture; qwen3-0.6b by
default; float32 compute) on the host from one seed, keeps its blocks
(``shard_state``) and runs the step inside ``logical_axes(mesh)``; rank 0
also runs the unmeshed step on the whole state and prints both losses
and grad norms a step and the mesh's collectives (calls, and bytes this
rank sent).  Raises if they differ by more than 1e-4 relative.  An MoE
stack runs at ``capacity_factor`` E/K, where neither step drops a token:
below it the mesh's per-block capacity and the unmeshed step's
per-group one drop different tokens.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch.distributed as dist

from ..configs import ARCH_IDS, smoke_config
from ..data.pipeline import SyntheticLMData
from ..device import stage
from ..distributed.axes import logical_axes
from ..distributed.sharding import shard_state
from ..launch.mesh import init_distributed, make_host_mesh
from ..optim.adamw import AdamWConfig
from ..train.step import init_train_state, make_train_step

STEPS, BATCH, SEQ, RTOL = 3, 8, 32, 1e-4


def run_mesh(arch: str, data_n: int, model_n: int, dev) -> list:
    """``STEPS`` steps of ``arch`` on a ``data_n x model_n`` mesh; returns
    its losses."""
    mesh = make_host_mesh(data_n, model_n, device=dev.type)
    cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    data = SyntheticLMData(cfg, BATCH, SEQ, seed=0)
    state = shard_state(cfg, init_train_state(cfg, opt, 0, "cpu"), mesh,
                        dev)
    plain = (init_train_state(cfg, opt, 0, "cpu") if mesh.rank == 0
             else None)
    step = make_train_step(cfg, opt)
    losses = []
    for i in range(STEPS):
        batch = data.batch_at(i)
        mesh.reset_collectives()
        with logical_axes(mesh, n_experts=cfg.n_experts):
            state, m = step(state, {k: stage(v, dev)
                                    for k, v in batch.items()})
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        losses.append(loss)
        if plain is None:
            continue
        plain, p = step(plain, {k: stage(v, plain["opt"]["step"].device)
                                for k, v in batch.items()})
        want, want_g = float(p["loss"]), float(p["grad_norm"])
        calls = {k: (c["calls"], c["bytes"])
                 for k, c in mesh.collectives.items() if c["calls"]}
        print(f"[train_mesh] {arch} step {i + 1} on {data_n}x{model_n}: "
              f"loss {loss:.6f} (unmeshed {want:.6f}), grad norm {gnorm:.6f} "
              f"(unmeshed {want_g:.6f}); collectives (calls, bytes this "
              f"rank sent) {calls}")
        if (abs(loss - want) > RTOL * abs(want)
                or abs(gnorm - want_g) > RTOL * abs(want_g)):
            raise RuntimeError(f"the mesh step is off the unmeshed one: "
                               f"{loss} vs {want}, {gnorm} vs {want_g}")
    return losses


def main(argv=None):
    """Every ``data x model`` mesh of the world's size in turn; returns
    their losses by shape."""
    ap = argparse.ArgumentParser(
        prog="torchrun ... -m repro_torch.examples.train_mesh")
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_IDS)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (nccl, one card a process) or 'cpu' (gloo)")
    args = ap.parse_args(argv)
    dev = init_distributed(args.device)
    n = dist.get_world_size()
    return {(d, n // d): run_mesh(args.arch, d, n // d, dev)
            for d in range(1, n + 1) if n % d == 0}


if __name__ == "__main__":
    main()
