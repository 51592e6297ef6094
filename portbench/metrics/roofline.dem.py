"""roofline.dem: the device work's share of its bandwidth roofline in the
scene ingest, in %: raster and stream bytes of the traced slice at 3.35
TB/s over the slice's device-active time (peaks.roofline_pct)."""

from portbench import peaks


def read(run):
    return peaks.roofline_pct(run)
