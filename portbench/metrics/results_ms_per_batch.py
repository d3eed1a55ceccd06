"""Self time of the program's ``merge`` and ``results`` spans (the
cross-segment merge and boxing the results, without the ``device_wait``
inside them) per traced wave, in ms."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_wave(run, ("merge", "results"))
