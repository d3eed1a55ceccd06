"""95th percentile of an acked ingest batch's time from when it was due to
its ack, over the window's acks outside the traced stretch."""

import numpy as np


def read(run):
    a, b = run.stretch
    lat = [(x["t1"] - x["due"]) * 1e3 for x in run.acks
           if x["ok"] and (x["t1"] <= a or x["due"] >= b)]
    return float(np.percentile(lat, 95)) if lat else None
