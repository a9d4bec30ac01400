"""Model API: the serving entry points of one architecture.

The counterpart of ``repro/models/api.py`` for the dense family:

  build(cfg, device, generator) → Model (weights drawn from the generator)
  model.prefill(batch, max_len) → (last logits, cache)
  model.decode_step(cache, tokens) → (logits, cache)
  model.init_cache(batch, max_len) → cache

``loss`` raises: training is a later slice (``ROADMAP.md`` Queue 1 item
15), and so are the other families, which ``build`` refuses.  Entry points
run on ``cuda`` unless the caller names another device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    module: T.Transformer

    @property
    def device(self) -> torch.device:
        return self.module.device

    def prefill(self, batch: Dict[str, torch.Tensor],
                max_len: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
        return T.prefill(self.module, batch, max_len)

    def decode_step(self, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        return T.decode_step(self.module, cache, tokens)

    def init_cache(self, batch: int, max_len: int) -> Dict:
        return T.init_cache(self.cfg, batch, max_len, self.device)

    def loss(self, *args, **kwargs):
        return T.loss_fn(*args, **kwargs)


def build(cfg: ArchConfig, device: DeviceLike = None,
          generator: Optional[torch.Generator] = None) -> Model:
    """The model of ``cfg`` on ``device`` (``cuda`` by default; raises
    without a card), its weights drawn from ``generator`` (default: one on
    the device seeded 0, as ``repro/launch/serve.py``'s ``key(0)``).  Raises
    ``NotImplementedError`` for a family the port does not run yet."""
    dev = resolve_device(device)
    T.check_supported(cfg)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    module = T.Transformer(cfg, dev)
    T.init_params(module, generator)
    return Model(cfg=cfg, module=module)
