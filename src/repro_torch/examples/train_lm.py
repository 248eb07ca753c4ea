"""End-to-end training driver: train a small LM for a few hundred steps on
synthetic data with the full stack (AdamW, checkpointing, resume,
straggler monitor, metrics log).  Counterpart of the reference's
``examples/train_lm.py``, with ``--device``.

The default is a ~10M-parameter qwen3-family model; ``--params 100``
scales to the ~100M-class configuration (same code path).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \\
        --steps 200
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from ..checkpoint import CheckpointManager
from ..data.pipeline import SyntheticLMData
from ..device import resolve_device, stage
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig
from ..train.loop import TrainLoop
from ..train.step import init_train_state, make_train_step
from ..tree import leaves


def config_for(params_m: int) -> ModelConfig:
    if params_m >= 100:
        return ModelConfig(name="lm100m", family="dense", n_layers=12,
                           d_model=640, n_heads=10, n_kv=5, head_dim=64,
                           d_ff=1708, vocab=32768, qk_norm=True,
                           tie_embeddings=True, remat=False)
    return ModelConfig(name="lm10m", family="dense", n_layers=6,
                       d_model=256, n_heads=8, n_kv=4, head_dim=32,
                       d_ff=683, vocab=8192, qk_norm=True,
                       tie_embeddings=True, remat=False)


def main(argv=None):
    """Train; returns the losses.  Raises if the last is not below the
    first."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.train_lm")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--params", type=int, default=10, choices=[10, 100])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = config_for(args.params)
    opt = AdamWConfig(lr=args.lr, warmup_steps=args.steps // 10)
    data = SyntheticLMData(cfg, args.batch, args.seq, seed=0)
    ckpt = CheckpointManager(args.ckpt_dir)
    state = init_train_state(cfg, opt, seed=0, device=dev)
    n_params = sum(x.numel() for x in leaves(state["params"]))
    print(f"[train_lm] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{args.steps} steps, batch {args.batch} x seq {args.seq} on {dev}")

    step_fn = make_train_step(cfg, opt)

    def step(state, batch):
        return step_fn(state, {k: stage(v, dev) for k, v in batch.items()})

    restored, start = ckpt.restore_latest(state)
    if restored is not None:
        state = restored
        print(f"[train_lm] resumed from step {start}")
    else:
        start = 0
    loop = TrainLoop(step, data.batch_at, ckpt, ckpt_every=100,
                     log_path=args.ckpt_dir + "/metrics.jsonl")
    t0 = time.time()
    state, end, losses = loop.run(state, start, args.steps)
    dt = time.time() - t0
    n = max(end - start, 1)
    print(f"[train_lm] {n} steps in {dt:.0f}s ({dt/n:.2f} s/step)")
    k = max(len(losses) // 10, 1)
    curve = [round(float(np.mean(losses[i:i+k])), 3)
             for i in range(0, len(losses), k)]
    print(f"[train_lm] loss curve (bucketed): {curve}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss should decrease: {losses[0]:.4f} -> "
                           f"{losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
