"""device_idle.best: 1 - device-active time / wall time over the traced
slice (the union of the profiler's device records; peaks.idle_share)."""

from portbench import peaks


def read(run):
    return peaks.idle_share(run)
