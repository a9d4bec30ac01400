"""PyTorch/CUDA port of the TOTEM-style BSP graph engine.

Mirrors the layout of the JAX package ``repro`` (``core``, ``kernels``,
``algorithms``, ``configs``) so each module's counterpart is easy to find,
and imports neither JAX nor ``repro``.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"`` (see :mod:`repro_torch.device`).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
