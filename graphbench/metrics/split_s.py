"""split_s: the hybrid planner and split's set-up (the engine's build, its
plan, and ``hybrid_for`` of the cell's program), host clock."""


def read(run):
    return run["setup"]["split_s"]
