"""setup_s: from the harness's start to the window's start (host clock):
imports, the protein directory written from the seed, the energy assembled
and loaded, the kernels built on a checkout's first run, the warm calls."""


def read(run):
    return run["setup_s"]
