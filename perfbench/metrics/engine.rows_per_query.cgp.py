"""Intermediate rows the engine produced (``ExecStats.rows_produced``,
the paper's cost) per query completed in the window."""


def read(run):
    if not run["queries_done"]:
        return None
    return run["rows_produced"] / run["queries_done"]
