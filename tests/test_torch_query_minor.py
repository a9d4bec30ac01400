"""One query-minor copy of the messages per superstep, shared by every
kernel op that reads them.

The kernels of ``ell_spmv_op``, ``bottomup_scan_op`` and
``outbox_reduce_op`` read ``x`` query-minor (``[x_len, Qp]``).  The engines
copy ``x`` there once per superstep (``ell_spmv.query_minor_view``) and
hand each op the ``[Q, x_len]`` view, which the op recognises and passes on
without another copy.  These tests run the engines on the CPU, where the
ops run their plain versions on the view, and record every copy and every
op call: each op must read the buffer of the superstep's one copy, and no
copy may go unread.  Results are held to the JAX package elsewhere
(``test_torch_engine_hybrid.py``, ``test_torch_distributed.py``,
``test_torch_direction.py``); here the engines with the copy recorded must
give what they give without the recording.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core import bsp as tbsp
from repro_torch.core import graph as TG
from repro_torch.core import hybrid as TH
from repro_torch.core import partition as TPT
from repro_torch.core.bsp import BSPEngine, DistributedBSPEngine
from repro_torch.kernels import ell_spmv as kell

talg = importlib.import_module("repro_torch.algorithms")

# (module, op name, position of x among the op's arguments)
OPS = [(TH, "ell_spmv_op", 3), (TH, "bottomup_scan_op", 3),
       (tbsp, "bottomup_scan_op", 3), (tbsp, "outbox_reduce_op", 0)]


@pytest.fixture
def events(monkeypatch):
    """Every query-minor copy (``("copy", buffer)``) and every kernel op
    call (``("op", name, buffer behind its x or None)``), in order."""
    log = []
    copy = kell.query_minor

    def counted(x, fill):
        out = copy(x, fill)
        if kell.query_minor_base(x) is None:
            log.append(("copy", out.data_ptr()))
        return out

    monkeypatch.setattr(kell, "query_minor", counted)
    for mod, name, at in OPS:
        def op(*args, _op=getattr(mod, name), _name=name, _at=at, **kw):
            base = kell.query_minor_base(args[_at])
            log.append(("op", _name, None if base is None
                        else base.data_ptr()))
            return _op(*args, **kw)
        monkeypatch.setattr(mod, name, op)
    return log


def _ops_per_copy(log):
    """Each copy with the ops that read it; fails on an op that reads no
    copy of this superstep or reads ``x`` itself."""
    groups = []
    for ev in log:
        if ev[0] == "copy":
            groups.append((ev[1], []))
            continue
        assert ev[2] is not None, f"{ev[1]} read x, not the engine's view"
        assert groups and ev[2] == groups[-1][0], (
            f"{ev[1]} read another buffer than the superstep's copy")
        groups[-1][1].append(ev[1])
    return groups


@pytest.fixture(scope="module")
def graph():
    g = TG.rmat(9, 8, seed=3).with_uniform_weights(seed=7)
    return g, TPT.partition(g, 2, TPT.HIGH, include_reverse=True)


@pytest.mark.parametrize("direction", ["auto", "pull"])
def test_hybrid_superstep_copies_x_once_for_its_kernel_ops(graph, events,
                                                           direction):
    g, pg = graph
    eng = BSPEngine(pg, backend="hybrid", device="cpu", direction=direction)
    plain = BSPEngine(pg, device="cpu", direction_switch=False)
    for run in (lambda e: talg.bfs_batched(e, [0, 5, 17]),
                lambda e: talg.sssp_batched(e, [0, 5])):
        events.clear()
        got = run(eng)
        groups = _ops_per_copy(list(events))
        assert groups and all(len(ops) == 1 for _, ops in groups)
        want = run(plain)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    events.clear()
    ranks = talg.pagerank(eng, 5)
    groups = _ops_per_copy(list(events))
    assert [ops for _, ops in groups] == [["ell_spmv_op"]] * 5
    np.testing.assert_allclose(ranks, talg.pagerank(plain, 5), rtol=1e-5)


def test_sharded_hybrid_reads_one_copy_in_the_spmv_and_the_outbox(graph,
                                                                  events):
    g, pg = graph
    eng = DistributedBSPEngine(pg, backend="hybrid", device="cpu")
    single = BSPEngine(pg, backend="hybrid", device="cpu")
    events.clear()
    ranks = talg.pagerank(eng, 4)
    groups = _ops_per_copy(list(events))
    assert [ops for _, ops in groups] == [
        ["ell_spmv_op", "outbox_reduce_op"]] * 4
    np.testing.assert_allclose(ranks, talg.pagerank(single, 4), rtol=1e-5)
    events.clear()
    levels, steps = talg.bfs_batched(eng, [0, 5, 17])
    groups = _ops_per_copy(list(events))
    assert len(groups) == int(np.max(steps))
    assert all(ops[-1] == "outbox_reduce_op" and len(ops) <= 2
               for _, ops in groups)
    want, want_steps = talg.bfs_batched(single, [0, 5, 17])
    np.testing.assert_array_equal(levels, want)
    np.testing.assert_array_equal(steps, want_steps)


def test_pull_superstep_scans_one_copy(graph, events):
    g, pg = graph
    eng = BSPEngine(pg, backend="fused", device="cpu", direction="pull")
    levels, steps = talg.bfs_batched(eng, [0, 5, 17])
    groups = _ops_per_copy(list(events))
    assert [ops for _, ops in groups] == [["bottomup_scan_op"]] * int(
        np.max(steps))
    want, want_steps = talg.bfs_batched(
        BSPEngine(pg, device="cpu", direction_switch=False), [0, 5, 17])
    np.testing.assert_array_equal(levels, want)
    np.testing.assert_array_equal(steps, want_steps)


@pytest.mark.parametrize("q", [1, 3, 4, 8, 13])
def test_query_minor_view_round_trip(q):
    """The view reads as ``x``; ``query_minor`` of the view is its buffer
    (no copy), whose padded lanes hold the fill; a plain ``x``, a
    transpose or a slice is copied."""
    x = torch.arange(q * 7, dtype=torch.float32).reshape(q, 7)
    xq = kell.query_minor_view(x, -1.0)
    assert torch.equal(xq, x) and xq.shape == (q, 7)
    base = kell.query_minor(xq, 0.0)
    assert base.data_ptr() == xq.data_ptr()
    qp = -(-q // 4) * 4
    assert base.shape == (7, qp) and bool((base[:, q:] == -1.0).all())
    assert kell.query_minor_base(x) is None
    assert kell.query_minor_base(x.double()) is None
    assert kell.query_minor_view(xq, 5.0).data_ptr() == xq.data_ptr()
    assert kell.query_minor(x[:, 1:], 0.0).data_ptr() != x.data_ptr()
