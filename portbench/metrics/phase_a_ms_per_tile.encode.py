"""phase_a_ms_per_tile.encode: device ms of the fast phase A (the
program's encode.phase_a spans, timed by CUDA events on the pipeline's
compute stream) per tile, over the window of the pipelined encode."""

from portbench import spans

spans.switch_on()


def read(run):
    return spans.ms_per_tile(run, "encode.phase_a", "device_ms")
