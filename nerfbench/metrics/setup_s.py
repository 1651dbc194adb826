"""setup_s: seconds from the process's start to the window's start
(loading, the scene and grid build, the kernels' build on a first run, the
warm-up)."""


def read(rec):
    return rec["setup_s"]
