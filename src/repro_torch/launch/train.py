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
on-disk format, so either package resumes the other's).  Only the host
mesh exists here: ``--mesh pod``/``multipod`` wait for ROADMAP.md § A14b.
Batches reach the device through pinned buffers (``device.stage``), so a
step waits on nothing but the loss the loop reads.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

from ..checkpoint import CheckpointManager
from ..configs import ARCH_IDS, get_config, smoke_config
from ..data.pipeline import SyntheticLMData
from ..device import resolve_device, stage
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


def main(argv=None):
    """Train; returns (state, the step reached, the losses of this run,
    the loop)."""
    args = parse_args(argv)
    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh}: training on a device mesh is not ported "
            f"yet (ROADMAP.md § A14b)")
    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, grad_accum=1)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1))

    data = SyntheticLMData(cfg, args.batch, args.seq, seed=args.seed)
    ckpt = CheckpointManager(args.ckpt_dir)
    state = init_train_state(cfg, opt_cfg, args.seed, dev)
    restored, start = ckpt.restore_latest(state)
    if restored is not None:
        state, start_step = restored, start
        print(f"[train] resumed from step {start_step}")
    else:
        start_step = 0
    step_fn = make_train_step(cfg, opt_cfg)

    def step(state, batch):
        return step_fn(state, {k: stage(v, dev) for k, v in batch.items()})

    loop = TrainLoop(step, data.batch_at, ckpt, log_path=args.log,
                     ckpt_every=args.ckpt_every)
    t0 = time.time()
    state, end_step, losses = loop.run(state, start_step, args.steps)
    dt = time.time() - t0
    n = end_step - start_step
    if n:
        print(f"[train] {cfg.name}: steps {start_step}->{end_step} "
              f"({dt/max(n,1):.2f}s/step)  loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}  (min {losses.min():.4f})  "
              f"stragglers={loop.monitor.slow_steps}")
    else:
        print(f"[train] {cfg.name}: nothing to do at step {start_step} of "
              f"{args.steps}")
    return state, end_step, losses, loop


if __name__ == "__main__":
    main()
