"""CUDA kernels the profiler saw run in the traced window, per query
completed in it."""


def read(run):
    tr = run.get("trace")
    if tr is None or not run["traced_done"]:
        return None
    return tr.kernels / run["traced_done"]
