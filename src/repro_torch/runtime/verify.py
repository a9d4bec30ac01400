"""Self-certifying fixpoints: linear-time result certifiers + in-loop monitors.

A BSP fixpoint is expensive to compute but cheap to *certify*: once the
vertex program has converged, each algorithm's defining inequality can be
checked in one O(V+E) sweep over the CSR arrays, with no reference to how
the result was produced.  That asymmetry is the whole defense against
silent corruption — a bit-flip that survives the min/sum combine, the
exchange, checkpointing, and harvest still has to explain itself against
the graph.

Two layers live here:

* ``ResultCertifier`` — per-algorithm post-hoc certifiers, numpy on the
  host (a harvested result is on the host already).  Each returns a
  structured :class:`Verdict` (named checks with violation counts), never a
  bare bool, so quarantine records and drill reports can say *which*
  invariant a corrupted result broke.
* ``InvariantMonitor`` — an in-loop observer of the chunked loop's window
  snapshots (``execute(chunk=, monitor=)``): min-semiring monotonicity
  (state never increases across windows), semiring-aware finiteness, and
  frontier sanity (finished votes never regress, per-slot step counters
  advance by at most one chunk).  It computes with torch where the state
  lies, so a state on the card stays there: only ``[Q]`` slot masks reach
  the host.

Port of the JAX package's ``runtime/verify.py``: the certifiers' verdicts
and the monitor's records equal its own for the same inputs.

Certifier contracts:

=========  ==================================================================
bfs        ``level[src] == 0``; finite levels are non-negative integers; no
           edge spans more than one level (``level[v] <= level[u] + 1``);
           every finite non-source level has an in-edge parent at exactly
           ``level - 1``.
sssp       ``dist[src] == 0``; no relaxable edge
           (``dist[v] <= f32(dist[u] + w)``); every finite non-source
           distance is *witnessed* by some in-edge achieving it (rules out
           the all-zeros state, which no-relaxable-edge alone accepts).
cc         labels are integral vertex ids with ``label[v] <= v``; edge
           endpoints agree (run on the symmetrized graph); labels are
           root-fixed (``label[label[v]] == label[v]``).
pagerank   finite non-negative ranks; total mass in
           ``[(1-d) - tol, 1 + tol]`` (dangling vertices leak mass); one
           extra power-iteration step moves the vector by at most the
           ``2·d^k`` contraction bound.
bc         sampled pair-recomputation against the O(V+E) Brandes reference
           for the given source.
=========  ==================================================================
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "CheckResult", "Verdict", "ResultCertifier", "InvariantMonitor",
    "certify", "register_certifier", "registered_algorithms", "monitor_for",
]


# ---------------------------------------------------------------------------
# structured verdicts


@dataclasses.dataclass(frozen=True)
class CheckResult:
    """One named invariant check: how many violations, and where/why."""
    name: str
    ok: bool
    violations: int = 0
    detail: str = ""


@dataclasses.dataclass(frozen=True)
class Verdict:
    """Outcome of certifying one result vector against one graph."""
    algorithm: str
    ok: bool
    checks: Tuple[CheckResult, ...]

    def failed(self) -> List[CheckResult]:
        return [c for c in self.checks if not c.ok]

    def reason(self) -> str:
        """Comma-joined names of the violated checks ('' when ok)."""
        return ",".join(c.name for c in self.checks if not c.ok)

    def summary(self) -> dict:
        return {
            "algorithm": self.algorithm, "ok": self.ok,
            "failed": [dataclasses.asdict(c) for c in self.failed()],
        }


def _check(name: str, bad_mask, detail: str = "") -> CheckResult:
    bad = np.asarray(bad_mask)
    n_bad = int(bad.sum()) if bad.shape else int(bad)
    if n_bad and not detail:
        where = np.flatnonzero(np.atleast_1d(bad))[:4].tolist()
        detail = f"first offenders at {where}"
    return CheckResult(name=name, ok=n_bad == 0, violations=n_bad,
                       detail=detail)


# ---------------------------------------------------------------------------
# per-algorithm certifiers — each fn(g, result, source, **params) -> checks


_CERTIFIERS: Dict[str, Callable] = {}


def register_certifier(name: str):
    def deco(fn):
        _CERTIFIERS[name] = fn
        return fn
    return deco


def registered_algorithms() -> List[str]:
    return sorted(_CERTIFIERS)


def _in_edge_min(g, values: np.ndarray) -> np.ndarray:
    """Per-vertex min over in-edges of ``values[src] (+ already applied)``.

    ``values`` is per-*edge* (length E, ordered like ``g.col``); returns the
    min received by each destination vertex, inf where no in-edges.
    """
    best = np.full(g.num_vertices, np.inf, dtype=np.float64)
    np.minimum.at(best, g.col, values)
    return best


@register_certifier("bfs")
def _certify_bfs(g, level, source=None, **params):
    level = np.asarray(level, dtype=np.float64)
    fin = np.isfinite(level)
    checks = []
    if source is not None:
        checks.append(_check("source_zero", level[int(source)] != 0.0,
                             detail=f"level[{int(source)}]={level[int(source)]}"))
    checks.append(_check("integral_nonneg",
                         fin & ((level < 0) | (level != np.floor(level)))))
    src = params.get("_src")
    src = g.edge_sources() if src is None else src
    # No edge spans more than one level: a reached u must not leave v at a
    # level beyond u+1 (an unreached v with a reached parent violates too —
    # inf > level[u]+1).
    checks.append(_check("edge_span",
                         np.isfinite(level[src]) & (level[g.col] > level[src] + 1)))
    # Every finite non-source level has a parent at exactly level-1.
    best = _in_edge_min(g, level[src])
    needs = fin & (level > 0)
    if source is not None:
        needs[int(source)] = False
    checks.append(_check("parent_witness", needs & (best + 1 != level)))
    return checks


@register_certifier("sssp")
def _certify_sssp(g, dist, source=None, rtol=1e-5, atol=1e-5, **params):
    if g.weights is None:
        raise ValueError("sssp certifier needs an edge-weighted graph "
                         "(CSRGraph.weights is None)")
    dist = np.asarray(dist, dtype=np.float64)
    checks = []
    if source is not None:
        checks.append(_check("source_zero", dist[int(source)] != 0.0,
                             detail=f"dist[{int(source)}]={dist[int(source)]}"))
    src = params.get("_src")
    src = g.edge_sources() if src is None else src
    # Relaxation candidates exactly as the engine computes them: f32 sums.
    cand = (dist[src].astype(np.float32)
            + np.asarray(g.weights, dtype=np.float32)).astype(np.float64)
    tol = atol + rtol * np.where(np.isfinite(cand), np.abs(cand), 0.0)
    checks.append(_check("no_relaxable_edge", dist[g.col] > cand + tol))
    # Tight witness: each finite non-source dist is achieved by some in-edge
    # (kills the all-zeros state that no-relaxable-edge alone accepts).
    best = _in_edge_min(g, cand)
    needs = np.isfinite(dist)
    if source is not None:
        needs[int(source)] = False
    wtol = atol + rtol * np.where(np.isfinite(best), np.abs(best), 0.0)
    checks.append(_check("tight_witness", needs & ~(np.abs(best - dist) <= wtol)))
    return checks


@register_certifier("cc")
def _certify_cc(g, labels, source=None, **params):
    """Certify min-label CC.  ``g`` must be the symmetrized graph the
    propagation ran on (``algorithms.cc.symmetrize``)."""
    lab = np.asarray(labels, dtype=np.float64)
    n = g.num_vertices
    ids = np.arange(n, dtype=np.float64)
    fin = np.isfinite(lab)
    checks = [
        _check("finite_integral",
               ~fin | (lab < 0) | (lab != np.floor(lab)) | (lab >= n)),
        _check("label_minimal", fin & (lab > ids)),
    ]
    src = params.get("_src")
    src = g.edge_sources() if src is None else src
    checks.append(_check("endpoint_agreement", lab[src] != lab[g.col]))
    # Labels are component roots: following the label once is a fixpoint.
    safe = np.where(fin, lab, 0).astype(np.int64)
    checks.append(_check("root_fixpoint", fin & (lab[safe] != lab)))
    return checks


@register_certifier("pagerank")
def _certify_pagerank(g, rank, source=None, num_iterations=20,
                      damping=0.85, tol=1e-3, **params):
    rank = np.asarray(rank, dtype=np.float64)
    n = g.num_vertices
    checks = [_check("finite_nonneg", ~np.isfinite(rank) | (rank < -1e-9))]
    # Mass conservation: dangling vertices leak (the engine drops their
    # rank), so total mass lives in [(1-d), 1] up to f32 accumulation noise.
    mass = float(rank.sum())
    mass_ok = (1.0 - damping) - tol <= mass <= 1.0 + tol
    checks.append(CheckResult("mass_conservation", mass_ok,
                              violations=0 if mass_ok else 1,
                              detail=f"mass={mass:.6f}"))
    # Residual bound: the damped map is a d-contraction in l1, so after k
    # iterations one more step moves the vector by at most 2·d^k.
    deg = g.out_degrees().astype(np.float64)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0)
    src = params.get("_src")
    src = g.edge_sources() if src is None else src
    push = (rank * inv)[src]
    acc = np.zeros(n, dtype=np.float64)
    np.add.at(acc, g.col, push)
    nxt = (1.0 - damping) / n + damping * acc
    resid = float(np.abs(nxt - rank).sum())
    bound = 2.0 * damping ** int(num_iterations) + tol
    checks.append(CheckResult("residual_bound", resid <= bound,
                              violations=0 if resid <= bound else 1,
                              detail=f"l1 residual {resid:.3e} > bound "
                                     f"{bound:.3e}" if resid > bound else
                                     f"l1 residual {resid:.3e}"))
    return checks


@register_certifier("bc")
def _certify_bc(g, bc, source=None, sample=512, rtol=1e-3, atol=1e-4,
                seed=0, **params):
    """Sampled pair-recomputation: Brandes' single-source pass is itself
    O(V+E), so the certificate is a reference recompute compared at a
    deterministic vertex sample (all vertices on small graphs)."""
    if source is None:
        raise ValueError("bc certifier needs the query source vertex")
    from repro_torch.algorithms.bc import bc_reference
    bc = np.asarray(bc, dtype=np.float64)
    ref = np.asarray(bc_reference(g, int(source)), dtype=np.float64)
    n = g.num_vertices
    if n <= sample:
        idx = np.arange(n)
    else:
        rng = np.random.default_rng(seed + int(source))
        idx = np.unique(np.concatenate([
            rng.choice(n, size=sample, replace=False),
            np.argsort(ref)[-16:],          # always check the heavy hitters
        ]))
    err = np.abs(bc[idx] - ref[idx])
    bad = err > (atol + rtol * np.abs(ref[idx]))
    detail = ""
    if bad.any():
        worst = idx[int(np.argmax(err))]
        detail = (f"vertex {int(worst)}: got {bc[worst]:.5f} "
                  f"want {ref[worst]:.5f}")
    return [_check("pair_recompute", bad, detail=detail),
            _check("finite_nonneg", ~np.isfinite(bc) | (bc < -1e-6))]


# ---------------------------------------------------------------------------
# public certifier handle


class ResultCertifier:
    """Certifier bound to one graph: ``certify(result, source)`` -> Verdict.

    Also owns the recompute-once policy's reference oracle: ``recompute``
    returns the trusted NumPy answer for one query so the serving layer can
    distinguish a corrupted-but-retryable result from a persistent fault.
    """

    def __init__(self, algorithm: str, g, **params):
        if algorithm not in _CERTIFIERS:
            raise ValueError(
                f"no certifier registered for {algorithm!r}; "
                f"known: {registered_algorithms()}")
        self.algorithm = algorithm
        self.g = g
        self.params = params
        # edge_sources() is an O(E) np.repeat with no caching on the graph;
        # a bound certifier runs once per query, so expand it exactly once.
        self._src = None

    def _edge_src(self) -> np.ndarray:
        if self._src is None:
            self._src = np.asarray(self.g.edge_sources())
        return self._src

    def certify(self, result, source: Optional[int] = None) -> Verdict:
        # inf/NaN are expected *inputs* (unreached vertices, poisoned
        # states); the checks classify them, so numpy's arithmetic
        # warnings on non-finite intermediates are noise here
        with np.errstate(invalid="ignore"):
            checks = tuple(_CERTIFIERS[self.algorithm](
                self.g, np.asarray(result), source=source,
                _src=self._edge_src(), **self.params))
        return Verdict(algorithm=self.algorithm,
                       ok=all(c.ok for c in checks), checks=checks)

    def certify_batch(self, results,
                      sources: Optional[Sequence[int]] = None) -> List[Verdict]:
        rows = np.asarray(results)
        if rows.ndim == 1:
            rows = rows[None]
        srcs = list(sources) if sources is not None else [None] * len(rows)
        return [self.certify(row, src) for row, src in zip(rows, srcs)]

    def recompute(self, source: Optional[int] = None) -> np.ndarray:
        """Trusted reference answer for one query (NumPy, engine-free)."""
        alg = self.algorithm
        if alg == "bfs":
            from repro_torch.algorithms.bfs import bfs_reference
            return bfs_reference(self.g, int(source))
        if alg == "sssp":
            from repro_torch.algorithms.sssp import sssp_reference
            return sssp_reference(self.g, int(source))
        if alg == "cc":
            from repro_torch.algorithms.cc import cc_reference
            return cc_reference(self.g)
        if alg == "pagerank":
            from repro_torch.algorithms.pagerank import pagerank_reference
            return np.asarray(pagerank_reference(
                self.g,
                num_iterations=self.params.get("num_iterations", 20),
                damping=self.params.get("damping", 0.85)))
        if alg == "bc":
            from repro_torch.algorithms.bc import bc_reference
            return bc_reference(self.g, int(source))
        raise ValueError(f"no reference oracle for {alg!r}")


def certify(algorithm: str, g, result, source: Optional[int] = None,
            **params) -> Verdict:
    """One-shot convenience: ``certify('bfs', g, levels, source=0)``."""
    return ResultCertifier(algorithm, g, **params).certify(result, source)


# ---------------------------------------------------------------------------
# in-loop invariant monitor (window-boundary observer, torch on the state's
# device)


_MONITOR_KEYS = {
    # keys monitored per algorithm; combine decides finiteness semantics.
    "bfs": (("level",), "min"),
    "sssp": (("dist",), "min"),
    "cc": (("label",), "min"),
    "pagerank": (("rank",), "sum"),
    # BC's forward dist legitimately holds inf for unreached vertices, so
    # only the sum-accumulated leaves are finiteness-checked.
    "bc": (("sigma",), "sum"),
}


def monitor_for(algorithm: str, chunk: Optional[int] = None) -> "InvariantMonitor":
    if algorithm not in _MONITOR_KEYS:
        raise ValueError(f"no monitor profile for {algorithm!r}; "
                         f"known: {sorted(_MONITOR_KEYS)}")
    keys, combine = _MONITOR_KEYS[algorithm]
    return InvariantMonitor(keys=keys, combine=combine, chunk=chunk)


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(x if isinstance(x, torch.Tensor)
                           else np.asarray(x), device=device)


class InvariantMonitor:
    """Cross-window invariant observer for the chunked superstep loop.

    The loop calls :meth:`observe` once per window with the boundary
    snapshot (state / finished / steps_q / step), and :meth:`rebase` after
    a slot refill so admitted slots get fresh baselines instead of firing
    spurious monotonicity violations.

    The checks run in torch on the device of the monitored leaves: the
    previous window's leaves are kept there as clones, and one copy of the
    ``[Q]`` slot masks per window reaches the host (the records' slot
    lists).  A state on the card is never copied whole.

    Checks per window:

    * finiteness — semiring-aware (sum: any non-finite; min: NaN/-inf —
      +inf is the legal "unreached" value), scoped to *unfinished* slots so
      NaN-frozen quarantined slots don't re-fire every window;
    * monotonicity (min combines only) — monitored leaves never increase
      across windows on surviving slots;
    * frontier sanity — finished votes never regress and per-slot step
      counters advance by a non-negative amount bounded by the chunk size.
    """

    def __init__(self, keys: Sequence[str], combine: str = "min",
                 chunk: Optional[int] = None):
        self.keys = tuple(keys)
        self.combine = combine
        self.chunk = None if chunk is None else int(chunk)
        self.windows = 0
        self.fired: List[dict] = []
        self._prev: Optional[Dict[str, torch.Tensor]] = None
        self._prev_fin: Optional[torch.Tensor] = None
        self._prev_steps: Optional[torch.Tensor] = None
        self._skip: Optional[np.ndarray] = None   # slots refilled last window

    @property
    def violations(self) -> int:
        return sum(rec["violations"] for rec in self.fired)

    def rebase(self, admit) -> None:
        """Mark slots refilled this window: their next-window comparison
        against the pre-refill baseline would be meaningless."""
        admit = np.asarray(admit, dtype=bool)
        if self._skip is None:
            self._skip = admit.copy()
        else:
            self._skip = self._skip | admit

    def observe(self, snap: dict) -> dict:
        state = snap["state"]
        keys = [k for k in self.keys if k in state]
        dev = (state[keys[0]].device if keys
               and isinstance(state[keys[0]], torch.Tensor) else None)
        fin = _on(snap["finished"], dev).to(torch.bool).reshape(-1)
        steps_q = _on(snap["steps_q"], dev).to(torch.int64).reshape(-1)
        q = fin.shape[0]
        skip = _on(self._skip if self._skip is not None
                   else np.zeros(q, dtype=bool), dev)
        # (check, key, [Q] slot mask), in the JAX package's order; the masks
        # reach the host in one copy below
        masks: List[Tuple[str, Optional[str], torch.Tensor]] = []
        cur: Dict[str, torch.Tensor] = {}
        for key in keys:
            flat = _on(state[key], dev)
            flat = flat.reshape(flat.shape[0], -1)
            if not flat.is_floating_point():
                flat = flat.double()
            if self.combine == "sum":
                bad = ~torch.isfinite(flat)
            else:
                bad = torch.isnan(flat) | torch.isneginf(flat)
            masks.append(("finiteness", key, bad.any(dim=1) & ~fin))
            prev = None if self._prev is None else self._prev.get(key)
            if (self.combine == "min" and prev is not None
                    and prev.shape == flat.shape):
                # NaN comparisons are False, so poisoned slots surface via
                # the finiteness check above, not a spurious increase here.
                masks.append(("monotonicity", key,
                              (flat > prev).any(dim=1) & ~skip))
            cur[key] = flat.clone()
        if self._prev_fin is not None and self._prev_fin.shape == fin.shape:
            masks.append(("finished_regressed", None,
                          self._prev_fin & ~fin & ~skip))
        if (self._prev_steps is not None
                and self._prev_steps.shape == steps_q.shape):
            delta = steps_q - self._prev_steps
            bad_d = (delta < 0) & ~skip
            if self.chunk is not None:
                bad_d |= (delta > self.chunk) & ~skip
            masks.append(("steps_delta", None, bad_d))

        found: List[dict] = []
        if masks:
            rows = torch.stack([m for _, _, m in masks]).cpu().numpy()
            for (check, key, _), row in zip(masks, rows):
                if row.any():
                    rec = dict(check=check)
                    if key is not None:
                        rec["key"] = key
                    rec["slots"] = np.flatnonzero(row).tolist()
                    found.append(rec)
        self._prev = cur
        self._prev_fin = fin.clone()
        self._prev_steps = steps_q.clone()
        self._skip = None
        self.windows += 1
        rec = dict(step=int(snap.get("step", -1)), violations=len(found),
                   checks=found)
        if found:
            self.fired.append(rec)
        return rec
