"""batch_p95_ms: the 95th percentile, over every batch finalized inside
the window, of the milliseconds from its ``mih_search_dispatch`` call to
the return of its ``mih_search_finalize`` (host clock). On several
cards: rank 0's, from the batch's broadcast to the return of rank 0's
sharded search call."""

import numpy as np


def read(run):
    lat = run.window.latencies
    return float(np.percentile(lat, 95) * 1e3) if lat else None
