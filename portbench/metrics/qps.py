"""Queries whose results came back in the window, over its seconds."""


def read(run):
    return run.traffic["wave"] * len(run.completed()) / run.seconds
