"""Self time of the program's ``stage`` spans (each fused executor's
query-side staging before its segment loop) per traced wave, in ms."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_wave(run, ("stage",))
