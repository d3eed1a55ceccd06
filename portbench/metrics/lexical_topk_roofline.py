"""The least time the traced stretch's term, bool, sort, range and facet
waves could take (``portbench/roofline.py``) over the stretch's device busy
time, in %."""

from portbench import roofline


def read(run):
    return roofline.share(run, ("term", "bool", "sort", "range", "facet"))
