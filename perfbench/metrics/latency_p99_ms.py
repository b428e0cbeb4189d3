"""99th percentile of the window's request latencies (``latencies_ms``:
milliseconds from a request's send to its answer on the host, one sample
per request completed; a failed request adds none)."""
import numpy as np


def read(run):
    lat = run["latencies_ms"]
    if not lat:
        return None
    return float(np.percentile(lat, 99))
