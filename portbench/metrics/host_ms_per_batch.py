"""(Traced wall time - device busy time) over the traced stretch's
``search_batch`` calls, in ms."""


def read(run):
    waves = run.traced_waves()
    if run.profile is None or not waves:
        return None
    p = run.profile
    return (p["window_s"] - p["busy_s"]) / len(waves) * 1e3
