"""Kernel launches the port's wrappers counted over the window, per
``search_batch`` call.  Nothing on a run without the card."""


def read(run):
    return run.launches / len(run.waves) if run.waves and run.launches else None
