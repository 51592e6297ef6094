"""upload_ms_per_tile.encode: host ms of the pipelined encode's upload
(the program's pipeline.upload spans: the staging into page-locked memory
and the copy's enqueue) per tile, over the window."""

from portbench import spans

spans.switch_on()


def read(run):
    return spans.ms_per_tile(run, "pipeline.upload", "host_ms")
