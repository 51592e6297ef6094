"""fetch_wait_ms_per_tile.encode: host ms the pipelined encode waits for a
batch's fetch event before its finish (the program's pipeline.fetch_wait
spans) per tile, over the window: the host's slack, near 0 when the host
stages bound the rate."""

from portbench import spans

spans.switch_on()


def read(run):
    return spans.ms_per_tile(run, "pipeline.fetch_wait", "host_ms")
