"""95th percentile of the host time of a wave's ``search_batch`` call, over
the waves that finished in the window outside the traced stretch."""

import numpy as np


def read(run):
    a, b = run.stretch
    lat = [(w["t1"] - w["t0"]) * 1e3 for w in run.completed()
           if w["t1"] <= a or w["t0"] >= b]
    return float(np.percentile(lat, 95)) if lat else None
