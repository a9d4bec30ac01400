"""Deterministic, seekable synthetic token pipeline.

A copy of ``repro/data/tokens.py``: ``batch_at(step)`` is a pure function
of (seed, step), drawn from numpy's ``SeedSequence([seed, step])``, so its
tokens equal the JAX package's bit for bit.  The distribution is Zipfian
(vocabulary skew).  The vision and audio front ends' inputs (``patches``
and ``frames``, stand-ins for their encoders' embeddings) are drawn after
the tokens from the same generator, as the JAX package draws them, so they
are equal bit for bit too.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.models.common import ArchConfig


@dataclasses.dataclass(frozen=True)
class TokenStream:
    cfg: ArchConfig
    batch: int
    seq: int
    seed: int = 0
    zipf_a: float = 1.2

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """``{"tokens": [batch, seq + 1] int32}`` on the CPU; a vision
        config adds ``patches [batch, frontend_len, d_model]`` and an
        encoder-decoder config ``frames [batch, min(seq, 4096), d_model]``,
        f32, ``normal * 0.02``."""
        cfg = self.cfg
        rng = self._rng(step)
        toks = rng.zipf(self.zipf_a, size=(self.batch, self.seq + 1))
        toks = np.minimum(toks - 1, cfg.vocab - 1).astype(np.int32)
        out = {"tokens": torch.from_numpy(toks)}

        def embeddings(length):
            a = rng.normal(size=(self.batch, length, cfg.d_model)) * 0.02
            return torch.from_numpy(a.astype(np.float32))

        if cfg.frontend == "vision":
            out["patches"] = embeddings(cfg.frontend_len)
        if cfg.enc_dec:
            out["frames"] = embeddings(min(self.seq, 4096))
        return out
