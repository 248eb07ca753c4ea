"""Deterministic, restart-safe data pipelines (a copy of
``repro/data/pipeline.py``; numpy only).

Both pipelines are pure functions of (seed, step, host_id) — after a
restart at step N, batch N is bit-identical, with no iterator state to
checkpoint.  The memmap dataset shards sequences across hosts by
striding, the standard layout for multi-host token files.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..models.config import ModelConfig


@dataclasses.dataclass
class SyntheticLMData:
    """Markov-ish synthetic tokens — enough structure for loss to fall."""
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host_id)
        b = self.batch // self.n_hosts
        s_text = self.seq - (self.cfg.n_vis_tokens or 0)
        # structured stream: tokens follow t+1 = (a*t + noise) mod V
        base = rng.integers(0, self.cfg.vocab, (b, 1))
        steps = rng.integers(0, 7, (b, s_text + 1)).cumsum(axis=1)
        toks = ((base * 31 + steps * 97) % self.cfg.vocab).astype(np.int32)
        out = {"tokens": toks[:, :-1],
               "labels": toks[:, 1:]}
        if self.cfg.is_encdec:
            out["audio_frames"] = rng.standard_normal(
                (b, self.cfg.n_audio_frames, self.cfg.d_model)
            ).astype(np.float32) * 0.02
        if self.cfg.n_vis_tokens:
            out["vision_embeds"] = rng.standard_normal(
                (b, self.cfg.n_vis_tokens, self.cfg.d_model)
            ).astype(np.float32) * 0.02
        return out


@dataclasses.dataclass
class MemmapTokenDataset:
    """Flat token file (uint16/uint32) → fixed windows, host-sharded."""
    path: str
    batch: int
    seq: int
    dtype: str = "uint16"
    n_hosts: int = 1
    host_id: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        self.n_windows = (len(self._data) - 1) // self.seq

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        b = self.batch // self.n_hosts
        idx0 = (step * self.batch + self.host_id * b) % max(
            self.n_windows - b, 1)
        toks = np.stack([
            self._data[(idx0 + i) * self.seq:(idx0 + i) * self.seq
                       + self.seq + 1].astype(np.int64)
            for i in range(b)])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def make_batch_fn(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                  path: Optional[str] = None):
    """``batch_at`` of the token file at ``path`` if it exists, else of the
    synthetic stream."""
    if path and Path(path).exists():
        ds = MemmapTokenDataset(path, batch, seq)
    else:
        ds = SyntheticLMData(cfg, batch, seq, seed)
    return ds.batch_at
