"""Time of the program's ``device_wait`` spans (the host blocked in a
group's first device-to-host copy) per traced wave, in ms.  It falls as the
device's work per wave falls, and grows as the host work before the copy
shrinks: device work the host used to hide behind its own then shows as
wait.  Read it beside the host metrics."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_wave(run, ("device_wait",), self_time=False)
