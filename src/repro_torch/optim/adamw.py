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

    def _terms(self, grads: Tree, state: AdamWState) -> "_Terms":
        """The step's terms shared by every leaf."""
        scale = None
        if self.clip_norm is not None:
            scale = torch.clamp_max(
                self.clip_norm / torch.clamp_min(global_norm(grads), 1e-9),
                1.0)
        step = state.step + 1
        stepf = step.float()
        bc1 = 1 - torch.tensor(self.b1, device=stepf.device) ** stepf
        bc2 = 1 - torch.tensor(self.b2, device=stepf.device) ** stepf
        return _Terms(scale, step, bc1, bc2, self._lr(step))

    def _leaf(self, t: "_Terms", g: torch.Tensor, m: torch.Tensor,
              n: torch.Tensor, p: torch.Tensor):
        """One leaf's new moments and its update ``(m, n, u)``."""
        if t.scale is not None:
            g = g * t.scale
        m = self.b1 * m + (1 - self.b1) * g
        n = self.b2 * n + (1 - self.b2) * g.square()
        u = -t.lr * ((m / t.bc1) / (torch.sqrt(n / t.bc2) + self.eps)
                     + self.weight_decay * p)
        return m, n, u

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamWState,
               params: Tree) -> Tuple[Tree, AdamWState]:
        """``(updates, new state)`` for gradients ``grads``."""
        t = self._terms(grads, state)
        out = tree_map(lambda g, m, n, p: self._leaf(t, g, m, n, p),
                       grads, state.mu, state.nu, params)
        mu, nu, updates = (tree_map(lambda o: o[i], out) for i in range(3))
        return updates, AdamWState(step=t.step, mu=mu, nu=nu)

    @torch.no_grad()
    def update_(self, grads: Tree, state: AdamWState,
                params: Tree) -> AdamWState:
        """``update`` then ``apply_updates``, written into ``params`` and
        the state's moments leaf by leaf (the arrays donated, as JAX's
        ``donate_argnums``): the same operations, so the same bits, with
        one leaf's temporaries alive at a time.  Returns the new state
        (its moments the same tensors)."""
        t = self._terms(grads, state)
        for g, m, n, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                              tree_leaves(state.nu), tree_leaves(params)):
            m_new, n_new, u = self._leaf(t, g, m, n, p)
            m.copy_(m_new)
            n.copy_(n_new)
            p.copy_((p + u).to(p.dtype))
        return AdamWState(step=t.step, mu=state.mu, nu=state.nu)


class _Terms(NamedTuple):
    scale: Optional[torch.Tensor]   # the clip's factor (None: no clip)
    step: torch.Tensor              # the new step count
    bc1: torch.Tensor               # the moments' bias corrections
    bc2: torch.Tensor
    lr: torch.Tensor                # the warmed-up learning rate


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
