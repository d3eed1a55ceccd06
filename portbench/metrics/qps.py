"""Queries whose results came back in the window, over its seconds (closed
loop: a wave's ``wave`` queries at its call's return; served: each answered
query at its wave's return)."""


def read(run):
    if run.served:
        return len(run.answered()) / run.seconds
    return run.traffic["wave"] * len(run.completed()) / run.seconds
