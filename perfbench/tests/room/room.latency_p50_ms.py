"""The room test's per-layer reader: the median of the window's request
latencies."""
import numpy as np


def read(run):
    lat = run["latencies_ms"]
    return float(np.median(lat)) if lat else None
