"""Reductions that several metrics share, each a ``read(run)``: the metric
files under ``metrics/`` name one of these per cell family, so a traversal
read under one end-to-end metric (``teps``) and under another
(``bfs_teps``) reduces its run the same way.  Each returns None where the
run holds nothing to read."""


def traversed_edges_per_s(run):
    """Traversed edges (Graph500's rule: the summed out-degrees of every
    query's reached vertices) over all calls of the window, divided by the
    summed walls of those calls (host clock).  The client's own work
    between calls (counting the edges, keeping the sample) is not the
    system's and is left out."""
    return run["window"]["traversed"] / sum(run["window"]["walls"])


def superstep_ms(run):
    """The summed walls of the window's calls (host clock), in
    milliseconds, over the supersteps the engine loop ran in them (each
    call's largest per-query count, summed)."""
    if not run["window"]["supersteps"]:
        return None
    return 1e3 * sum(run["window"]["walls"]) / run["window"]["supersteps"]


def device_idle(run):
    """The share of the traced calls' time in which no kernel, copy or
    memset ran on the device, in %."""
    t = run["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def result_copy_ms(run):
    """Device-to-host copy time in the trace per call (the entries'
    ``gather_batch`` copies the ``[Q, n]`` answers to the host)."""
    t = run["trace"]
    if not t or not t["dtoh_s"]:
        return None
    return 1e3 * t["dtoh_s"] / run["window"]["calls"]


def edges_examined_ratio(run):
    """The direction vote's examined edges
    (``BSPEngine.last_direction_stats["edges_examined"]``, summed over every
    call and query) over queries times |E|."""
    w = run["window"]
    if not w.get("edges_examined"):
        return None
    return w["edges_examined"] / (w["queries"] * run["shapes"]["e"])
