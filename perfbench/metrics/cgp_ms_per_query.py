"""Milliseconds of the closed loop's window per query completed."""


def read(run):
    if not run["queries_done"]:
        return None
    return run["window_s"] * 1e3 / run["queries_done"]
