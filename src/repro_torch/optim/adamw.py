"""AdamW with global-norm clipping and linear warm-up, on trees of tensors.

Port of ``repro.optim.adamw``.  A tree is a tensor or a dict of trees (the
model's parameters: ``embed``, ``layers`` of stacked weights, ...); leaves
go in sorted-key order, the order of ``jax.tree.leaves``.  The step is
JAX's, term for term: clip the gradients by their global norm, update the
moments, correct their bias, and take ``-lr·(m̂/(√n̂ + eps) + wd·p)``
with the learning rate warmed up linearly over ``warmup_steps``.
``torch.optim.AdamW`` differs in its warm-up, its clipping and its state
layout (so its checkpoints would too), so the port does not use it.

Every function returns new tensors (the JAX functions are pure); nothing
here needs gradients, and it runs under ``torch.no_grad``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and of the trees of its shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The leaves in sorted-key order (``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar: updates taken
    mu: Tree
    nu: Tree


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100

    def init(self, params: Tree) -> AdamWState:
        leaf = tree_leaves(params)[0]
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=leaf.device),
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params))

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        warm = torch.clamp_max((step + 1) / max(self.warmup_steps, 1), 1.0)
        return self.learning_rate * warm

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamWState,
               params: Tree) -> Tuple[Tree, AdamWState]:
        """``(updates, new state)`` for gradients ``grads``."""
        if self.clip_norm is not None:
            g_norm = global_norm(grads)
            scale = torch.clamp_max(
                self.clip_norm / torch.clamp_min(g_norm, 1e-9), 1.0)
            grads = tree_map(lambda g: g * scale, grads)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda n, g: b2 * n + (1 - b2) * g.square(),
                      state.nu, grads)
        stepf = step.float()
        bc1 = 1 - torch.tensor(b1, device=stepf.device) ** stepf
        bc2 = 1 - torch.tensor(b2, device=stepf.device) ** stepf
        lr = self._lr(step)

        def upd(m, n, p):
            mhat = m / bc1
            nhat = n / bc2
            return -lr * (mhat / (torch.sqrt(nhat) + self.eps)
                          + self.weight_decay * p)

        updates = tree_map(upd, mu, nu, params)
        return updates, AdamWState(step=step, mu=mu, nu=nu)


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``p + u`` in each parameter's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


@torch.no_grad()
def global_norm(tree: Tree) -> torch.Tensor:
    """``sqrt(sum(x²))`` over every leaf, in f32, summed leaf by leaf in
    ``tree_leaves`` order."""
    total = None
    for x in tree_leaves(tree):
        s = x.float().square().sum()
        total = s if total is None else total + s
    return torch.sqrt(total)
