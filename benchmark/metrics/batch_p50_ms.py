"""batch_p50_ms: the median of the same per-batch times as
``batch_p95_ms`` (the entry layer, host clock; on several cards rank
0's, as there)."""

import numpy as np


def read(run):
    lat = run.window.latencies
    return float(np.percentile(lat, 50) * 1e3) if lat else None
