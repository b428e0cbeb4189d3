"""Device milliseconds of K1 (``wcoj_intersect``'s kernels) in the traced
window, per query completed in it."""


def read(run):
    tr = run.get("trace")
    if tr is None or not run["traced_done"]:
        return None
    return tr.kernel_seconds("k1") * 1e3 / run["traced_done"]
