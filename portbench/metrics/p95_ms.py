"""95th percentile of every query's latency, from the query's due time to
its results on the host.  Closed loop: a query is due at its wave's
``search_batch`` call, so its latency is that call's host time, over the
waves that finished in the window.  Served: a query is due at its scheduled
arrival, so its latency holds the submitter's delay, its wait in the front
end's queue and its wave's call, over every query offered in the window
that was answered, in the window or in the drain after it (a query shed,
raised or never answered is failed)."""

import numpy as np


def read(run):
    if run.served:
        lat = [(q["t1"] - q["due"]) * 1e3 for q in run.queries if q["ok"]]
        return float(np.percentile(lat, 95)) if lat else None
    lat = [(w["t1"] - w["t0"]) * 1e3 for w in run.completed()]
    if not lat:
        return None
    return float(np.percentile(np.repeat(lat, run.traffic["wave"]), 95))
