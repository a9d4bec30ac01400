"""Deterministic, seekable synthetic token pipeline.

A copy of ``repro/data/tokens.py``: ``batch_at(step)`` is a pure function
of (seed, step), drawn from numpy's ``SeedSequence([seed, step])``, so its
tokens equal the JAX package's bit for bit.  The distribution is Zipfian
(vocabulary skew).  Only token batches: the vision and audio inputs come
with those families (``ROADMAP.md`` Queue 1 item 15).
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
        """``{"tokens": [batch, seq + 1] int32}`` on the CPU."""
        if self.cfg.frontend or self.cfg.enc_dec:
            raise NotImplementedError(
                f"{self.cfg.name}: front-end inputs are not ported yet "
                f"(ROADMAP.md Queue 1 item 15)")
        rng = self._rng(step)
        toks = rng.zipf(self.zipf_a, size=(self.batch, self.seq + 1))
        toks = np.minimum(toks - 1, self.cfg.vocab - 1).astype(np.int32)
        return {"tokens": torch.from_numpy(toks)}
