"""device_idle.rgb16: 1 - device-active time / wall time over the traced
slice of the photo ingest (the union of the profiler's device records;
peaks.idle_share): how far the host stages hold the card back."""

from portbench import peaks


def read(run):
    return peaks.idle_share(run)
