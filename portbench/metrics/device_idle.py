"""100 * (1 - device busy / wall) over the traced stretch."""


def read(run):
    p = run.profile
    if p is None or not p["device_events"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
