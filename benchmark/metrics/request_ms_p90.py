"""The 90th percentile of every window request's latency (ms), from the
start of its host-to-device copy to its outputs back on the host, on the
host's clock.  The count of requests, and of those beyond the percentile,
goes to standard error first."""

import sys

import numpy as np

UNIT = "ms"
PERCENTILE = 90


def read(run):
    lat = np.asarray([(it["t1"] - it["t0"]) * 1e3 for it in run.items])
    if lat.size == 0:
        return None
    value = float(np.percentile(lat, PERCENTILE))
    print(f"request_ms_p90: {lat.size} requests in the window, "
          f"{int((lat > value).sum())} beyond the {PERCENTILE}th percentile",
          file=sys.stderr)
    return value
