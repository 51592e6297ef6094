"""phase_a_ms_per_tile.best: device ms of the best modes' phase A (the
program's encode.phase_a spans, one a pass of batch.best_encode_tiles,
timed by CUDA events) per tile, over the window of batch.encode_tiles."""

from portbench import spans

spans.switch_on()


def read(run):
    return spans.ms_per_tile(run, "encode.phase_a", "device_ms")
