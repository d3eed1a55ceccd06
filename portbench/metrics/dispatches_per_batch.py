"""Executor dispatches (``core/query/profile.capture()``) over the window,
per ``search_batch`` call."""


def read(run):
    return run.dispatches / len(run.waves) if run.waves else None
