"""Share of the traced window in which nothing ran on the card."""


def read(run):
    tr = run.get("trace")
    if tr is None or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
