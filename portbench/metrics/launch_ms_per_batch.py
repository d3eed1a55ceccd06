"""Self time of the program's ``segments`` spans (a fused executor's
segment loop: per segment the cache lookup, kernel wrapper and launches)
per traced wave, in ms."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_wave(run, ("segments",))
