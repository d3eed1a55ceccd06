"""The least time the traced stretch's vector and hybrid waves could take
(``portbench/roofline.py``) over the stretch's device busy time, in %."""

from portbench import roofline


def read(run):
    return roofline.share(run, ("vector", "hybrid"))
