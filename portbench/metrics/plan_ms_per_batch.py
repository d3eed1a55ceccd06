"""Self time of the program's ``plan`` spans (``plan_batch``) per traced
wave, in ms (``portbench/program_spans.py``)."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_wave(run, ("plan",))
