"""Deterministic synthetic data (a copy of ``repro/data/pipeline.py``'s
``SyntheticLMData``; numpy only).

A batch is a pure function of (seed, step, host_id): after a restart at
step N, batch N is bit-identical, with no iterator state to checkpoint.
``MemmapTokenDataset`` and ``make_batch_fn`` wait for the training port
(ROADMAP.md § A13).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

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
