"""setup_s: process start to the first timed call (graph generation, CSR
build, partition, engine and split, warm-up), host clock."""


def read(run):
    return run["setup"]["setup_s"]
