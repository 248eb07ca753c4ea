"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 20 --batch 8 --seq 64                        # on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 20 --batch 8 --seq 128 --ckpt-every 10       # on the card

Counterpart of ``repro/launch/train.py`` with the reference's flags and
``--device`` (default ``cuda``, which raises without a card; the CPU only
when asked for).  ``--smoke`` selects the reduced config; unlike the
reference's ``store_true`` it also has ``--no-smoke``, the default, the
published config.  The step runs at the config's own dtypes (float32
params, bfloat16 compute) with ``grad_accum`` 1, as in the reference.
Resume is automatic if ``--ckpt-dir`` holds a checkpoint (the reference's
on-disk format, so either package resumes the other's, whatever mesh
saved it).  Batches reach the device through pinned buffers
(``device.stage``), so a step waits on nothing but the loss the loop
reads.

``--mesh`` follows the reference's ``main``: the state specs cut the
train state (``shard_state``), the step runs SPMD inside
``logical_axes(mesh)``, and the checkpoints save and restore through the
state's shardings.  ``host`` is a 1x1 mesh (one device: the SPMD
step, bit-equal to the plain one); ``pod`` and ``multipod`` are the production meshes,
16 x 16 and 2 x 16 x 16, one process per device:

    torchrun --nproc-per-node 256 -m repro_torch.launch.train --mesh pod

On any other world size they raise, naming the count.  Only rank 0
prints and writes the log.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
import time

import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..configs import ARCH_IDS, get_config, smoke_config
from ..data.pipeline import SyntheticLMData
from ..device import resolve_device, stage
from ..distributed.axes import logical_axes
from ..distributed.sharding import shard_state, shardings_of, state_specs
from ..launch.mesh import (PRODUCTION_AXES, init_distributed,
                           make_host_mesh, make_production_mesh)
from ..optim.adamw import AdamWConfig
from ..train.loop import TrainLoop
from ..train.step import init_train_state, make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="the reduced smoke config (default: published)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log", default=None)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "pod", "multipod"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    return ap.parse_args(argv)


def _mesh(args):
    """(mesh, this rank's device) for ``--mesh``."""
    if args.mesh == "host":
        dev = resolve_device(args.device)
        return make_host_mesh(1, 1, device=dev.type), dev
    shape = PRODUCTION_AXES[args.mesh == "multipod"]
    n = math.prod(shape.values())
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    if world != n:
        raise RuntimeError(
            f"--mesh {args.mesh} trains on the production mesh "
            f"{'x'.join(map(str, shape.values()))} ({', '.join(shape)}): "
            f"it needs {n} processes, one per device, and this run has "
            f"{world}: launch with `torchrun --nproc-per-node {n} ...` "
            f"(or across hosts)")
    dev = init_distributed(args.device)
    return make_production_mesh(multi_pod=args.mesh == "multipod",
                                device=dev.type), dev


def main(argv=None):
    """Train; returns (state, the step reached, the losses of this run,
    the loop).  ``state`` is this rank's blocks on a mesh."""
    args = parse_args(argv)
    mesh, dev = _mesh(args)
    echo = print if mesh.rank == 0 else (lambda *a, **k: None)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, grad_accum=1)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1))

    data = SyntheticLMData(cfg, args.batch, args.seq, seed=args.seed)
    with logical_axes(mesh, n_experts=cfg.n_experts):
        # one device draws on it; a wider mesh draws on the host, so the
        # card holds only this rank's blocks
        state = init_train_state(cfg, opt_cfg, args.seed,
                                 dev if mesh.size == 1 else "cpu")
        st_sh = shardings_of(state_specs(cfg, state, mesh), mesh)
        state = shard_state(cfg, state, mesh, dev)
        ckpt = CheckpointManager(args.ckpt_dir, shardings=st_sh)
        restored, start = ckpt.restore_latest(state, st_sh)
        if restored is not None:
            state, start_step = restored, start
            echo(f"[train] resumed from step {start_step}")
        else:
            start_step = 0
        step_fn = make_train_step(cfg, opt_cfg)

        def step(state, batch):
            return step_fn(state, {k: stage(v, dev)
                                   for k, v in batch.items()})

        loop = TrainLoop(step, data.batch_at, ckpt,
                         log_path=args.log if mesh.rank == 0 else None,
                         ckpt_every=args.ckpt_every, mesh=mesh)
        t0 = time.time()
        state, end_step, losses = loop.run(state, start_step, args.steps)
        dt = time.time() - t0
    n = end_step - start_step
    if n:
        echo(f"[train] {cfg.name}: steps {start_step}->{end_step} "
             f"({dt/max(n,1):.2f}s/step)  loss {losses[0]:.4f} -> "
             f"{losses[-1]:.4f}  (min {losses.min():.4f})  "
             f"stragglers={loop.monitor.slow_steps}")
    else:
        echo(f"[train] {cfg.name}: nothing to do at step {start_step} of "
             f"{args.steps}")
    return state, end_step, losses, loop


if __name__ == "__main__":
    main()
