"""95th percentile of every query's latency in the window: the host time of
its wave's ``search_batch`` call, from the call to the results on the host."""

import numpy as np


def read(run):
    lat = [(w["t1"] - w["t0"]) * 1e3 for w in run.completed()]
    if not lat:
        return None
    return float(np.percentile(np.repeat(lat, run.traffic["wave"]), 95))
